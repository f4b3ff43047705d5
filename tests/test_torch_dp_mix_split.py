"""dp_mix's large-N mix in split TF32 (``csrc/dp_mix.cu::dp_mix_tiled``),
its arithmetic emulated in torch on the CPU, held to the float32
tolerance the card's tests hold the kernel to, before any card runs it.

The kernel cuts each element a of W and z as ``csrc/tf32x3.cuh`` does:
hi = (bits(a) + 0x1000) & 0xffffe000 (10 mantissa bits, nearest, ties
away from zero), lo = a - hi (exact in float32), which the tensor core
reads truncated to its top 10 mantissa bits. Each wgmma (k = 8) adds 8
senders' exact products (a TF32 product has 22 significant bits) to its
float32 sum: lo_z hi_W, then hi_z lo_W, then hi_z hi_W, every 8 senders
in order. The diagonal W_ii stays out of the products; the
epilogue adds it in float32, fmaf(W_ii, z_i, sum). The emulation sums
each mma's 8 products and the accumulator exactly (float64) and rounds
once to float32, to nearest or toward zero (tensor cores have been seen
to truncate), so both bracket what the hardware does.

Tolerance: ``tests/test_torch_cuda.py::test_kernel_matches_plain``'s, (N
+ 8) 2^-23 scale with scale = max|x| + 5.42 max|n/c| + 5.42 max|m_scale
sigma_m|, against the exact product (float64), and, with the plain
version's own float32 product (torch's CPU matmul), |emulated - exact| +
|plain - exact| within it too, so the kernel against its plain twin fits
that test's bound. Plans: the complete graph, a ring, sampled
participation and a churned dynamic round, at N = 64, 256 and 2048.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import exchange as X
from repro_torch.core.channel import ChannelConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MASK = -8192          # 0xffffe000 as int32: a TF32's bits
KSTEP = 8             # senders a wgmma (k8) adds


def split(a: torch.Tensor):
    """tf32x3.cuh's split of a float32 tensor: (hi, lo as the tensor core
    reads it)."""
    hi = ((a.view(torch.int32) + 0x1000) & MASK).view(torch.float32)
    lo = ((a - hi).view(torch.int32) & MASK).view(torch.float32)
    return hi, lo


def to_f32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """float64 to float32, to nearest or toward zero."""
    f = x.to(torch.float32)
    if mode == "rz":
        over = f.double().abs() > x.abs()
        f = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return f


def split_mix(W: torch.Tensor, z: torch.Tensor, mode: str) -> torch.Tensor:
    """W @ z as dp_mix_tiled computes it (the module's docstring)."""
    diag = torch.diagonal(W).clone()
    (wh, wl), (zh, zl) = split(W - torch.diag(diag)), split(z)
    acc = torch.zeros((W.shape[0], z.shape[1]), dtype=torch.float32)
    for k0 in range(0, W.shape[1], KSTEP):
        k = slice(k0, k0 + KSTEP)
        for a, b in ((wh, zl), (wl, zh), (wh, zh)):
            acc = to_f32(acc.double() + a[:, k].double() @ b[k].double(),
                         mode)
    # fmaf: the exact product and sum (float64 here), rounded once
    return (diag.double()[:, None] * z.double() + acc.double()).float()


def one_pass_mix(W: torch.Tensor, z: torch.Tensor, mode: str) -> torch.Tensor:
    """W @ z with the lo products dropped: one TF32 pass, hi_W hi_z, the
    diagonal as split_mix adds it. What the kernel would compute if it
    lost its split; the tests below show their bound catches it."""
    diag = torch.diagonal(W).clone()
    wh, zh = split(W - torch.diag(diag))[0], split(z)[0]
    acc = torch.zeros((W.shape[0], z.shape[1]), dtype=torch.float32)
    for k0 in range(0, W.shape[1], KSTEP):
        k = slice(k0, k0 + KSTEP)
        acc = to_f32(acc.double() + wh[:, k].double() @ zh[k].double(), mode)
    return (diag.double()[:, None] * z.double() + acc.double()).float()


def _plan(kind: str, N: int, chan):
    """A MixPlan on the CPU, as test_torch_cuda.py's ``_plan`` builds it
    on the card."""
    from repro_torch.core import protocol as P
    from repro_torch.net import fading, geometry, scenarios
    if kind == "complete":
        return X.plan_complete(None, chan, "cpu")
    if kind == "ring":
        return X.plan_topology(P.ProtocolConfig(n_workers=N, topology="ring"),
                               chan, "cpu")
    if kind == "sampled":
        return X.plan_sampled(None, chan, "cpu", torch.arange(N) % 2 == 0)
    scn = scenarios.get_scenario("iot_dense")
    gen = torch.Generator().manual_seed(N)
    pos = geometry.init_geometry(scn.geometry, gen, N).pos
    pos[-1] = 10.0 * scn.geometry.area
    mask = torch.arange(N) != 1
    W = geometry.metropolis_weights(geometry.adjacency(scn.geometry, pos,
                                                       mask=mask))
    tr = fading.channel_state(scn.fading, fading.init_fading(scn.fading, gen,
                                                             N),
                              float(chan.P[0]), chan.dp_sigma,
                              chan.awgn_sigma,
                              path_gain=geometry.path_gain(scn.geometry, pos))
    return X.plan_dynamic(None, tr, "cpu", W)


def _case(kind: str, N: int, d: int):
    """W, z = x + n/c and the tolerance's scale of a round at (N, d), the
    operands drawn with numpy from a seed."""
    chan = ChannelConfig(n_workers=N, p_dbm=30.0, sigma=0.7, sigma_m=0.4,
                         seed=N).realize()
    plan = _plan(kind, N, chan)
    rng = np.random.default_rng(N * 7 + d)
    p = torch.as_tensor(rng.standard_normal((N, d)), dtype=torch.float32)
    g = torch.as_tensor(0.2 * rng.standard_normal((N, d)),
                        dtype=torch.float32)
    gn = torch.as_tensor(rng.standard_normal((N, d)), dtype=torch.float32)
    c = plan.c.reshape(())
    x = p - 0.05 * g
    z = x + (plan.amp / c)[:, None] * gn
    scale = float(x.abs().max()) + 5.42 * float(
        (plan.amp / c).abs().max() + (plan.m_scale * plan.sigma_m).abs().max())
    return plan.W.contiguous(), z, scale


def test_split_is_exact_and_tf32():
    """hi + lo_full = a exactly, hi keeps 10 mantissa bits rounded to
    nearest (ties away from zero), the lo the tensor core reads is within
    2^-21 |a| of a - hi, and a TF32 product is exact in float32."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal(100_000) * 10.0 ** rng.integers(
        -6, 6, 100_000), dtype=torch.float32)
    hi, lo = split(a)
    lo_full = a - hi
    assert torch.equal(hi + lo_full, a)
    assert bool(((hi.view(torch.int32) & ~MASK) == 0).all())
    assert bool((lo_full.abs() <= 2.0 ** -11 * a.abs()).all())
    assert bool(((lo_full - lo).abs() <= 2.0 ** -21 * a.abs()).all())
    # a tie rounds away from zero: 1 + 2^-11 -> 1 + 2^-10
    t = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert split(t)[0].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    b = split(torch.as_tensor(rng.standard_normal(100_000),
                              dtype=torch.float32))[0]
    assert torch.equal((hi * b).double(), hi.double() * b.double())


@pytest.mark.parametrize("mode", ["rn", "rz"])
def test_split_mix_passes_z_through_an_identity_row(mode):
    """A row of W that is e_i gives z_i bitwise (the noise-field check's W
    = I, a dynamic round's isolated worker), and a zero W gives +0."""
    rng = np.random.default_rng(1)
    z = torch.as_tensor(rng.standard_normal((70, 33)), dtype=torch.float32)
    assert torch.equal(split_mix(torch.eye(70), z, mode), z)
    zero = split_mix(torch.zeros((70, 70)), z, mode)
    assert torch.equal(zero.view(torch.int32), torch.zeros_like(zero).view(
        torch.int32))


@pytest.mark.parametrize("N,d", [(64, 384), (256, 320), (2048, 192)])
@pytest.mark.parametrize("kind", ["complete", "ring", "sampled", "dynamic"])
def test_split_mix_within_the_float32_tolerance(N, d, kind):
    W, z, scale = _case(kind, N, d)
    tol = (N + 8) * 2.0 ** -23 * scale
    exact = W.double() @ z.double()
    plain = (W @ z).double()
    plain_err = (plain - exact).abs()
    for mode in ("rn", "rz"):
        err = (split_mix(W, z, mode).double() - exact).abs()
        assert float(err.max()) <= tol, (mode, float(err.max()), tol)
        assert float((err + plain_err).max()) <= tol, mode


# chip_smoke.dp_mix_split_tolerance's sqrt(N) 2^-23 scale: the size of N
# float32 roundings of random sign, which the card's split-precision checks
# hold the kernel to against float64. The split fits it at every plan and
# N; one TF32 pass does not where a row has few weights (the ring) or N is
# small, where the (N + 8) tolerance above would let it pass at N = 2048.
@pytest.mark.parametrize("N,d", [(64, 384), (129, 1001), (256, 320),
                                 (300, 517), (2048, 192)])
@pytest.mark.parametrize("kind", ["complete", "ring", "sampled", "dynamic"])
def test_split_mix_within_sqrt_n_float32_roundings(N, d, kind):
    W, z, scale = _case(kind, N, d)
    tol = N ** 0.5 * 2.0 ** -23 * scale
    exact = W.double() @ z.double()
    assert float(((W @ z).double() - exact).abs().max()) <= tol
    for mode in ("rn", "rz"):
        err = (split_mix(W, z, mode).double() - exact).abs()
        assert float(err.max()) <= tol, (mode, float(err.max()), tol)


@pytest.mark.parametrize("N,d,kind", [(64, 384, "complete"),
                                      (129, 1001, "complete"),
                                      (64, 384, "ring"), (300, 517, "ring"),
                                      (2048, 192, "ring")])
def test_one_tf32_pass_breaks_the_split_bound(N, d, kind):
    W, z, scale = _case(kind, N, d)
    tol = N ** 0.5 * 2.0 ** -23 * scale
    exact = W.double() @ z.double()
    for mode in ("rn", "rz"):
        err = (one_pass_mix(W, z, mode).double() - exact).abs()
        assert float(err.max()) > 2 * tol, (mode, float(err.max()), tol)
