"""The port's fused local step with DP noise on the CPU
(``repro_torch.kernels.dp_perturb``: ``dp_perturb_plain`` through the
``sgd_update``/``dp_perturb`` wrappers) against the reference's Pallas
kernel in interpret mode (``repro.kernels.dp_perturb.ops``, run as
tests/test_kernels.py runs it), at the reference's own test shapes and at
leaves that are not a multiple of 128 or span several 256-row tiles.

Tolerances, measured on the CPU:

* the counters, hash bits and uniforms are bitwise the reference's;
* x = p - gamma g is bitwise the reference's (XLA contracts it into one
  fused multiply-add, and so does the port); allowed 1 ULP;
* the Box-Muller normals differ by at most 3 ULP (10.8% of 5 x 2^20 draws
  differ at all): torch's log and cos are not XLA's; allowed
  NOISE_ULP = 4. So the noisy xt is within 4 ULP of its noise term plus
  1 ULP of itself; a bfloat16 output one bfloat16 step (2^-7 of its
  magnitude) further.

The reference records no Hypothesis examples for dp_perturb; its
parametrized cases are replayed here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dp_perturb import ops as ref_ops
from repro.kernels.dp_perturb import ref as ref_oracle
from repro.kernels.dp_perturb.dp_perturb import _hash_bits, _uniform_from_bits
from repro_torch.kernels import noise
from repro_torch.kernels.dp_perturb import ops
from repro_torch.kernels.dp_perturb.dp_perturb import dp_perturb_plain

NOISE_ULP = 4
SHAPES = [(64,), (1000, 37), (3, 17, 29), (256, 128), (3, 70001), (10, 256, 10)]
# dwfl-paper's six leaves in tree order (each layer's b, then w) at N = 4
# workers and hidden width 16
MLP_LEAVES = [(4, 16), (4, 3072, 16), (4, 16), (4, 16, 16), (4, 10), (4, 16, 10)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(a, b):
    """ULP distance of two float32 arrays (signs may differ)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _inputs(shape, jdt, tdt, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return (jnp.asarray(p).astype(jdt), jnp.asarray(g).astype(jdt),
            torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt))


def _f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


@pytest.mark.parametrize("seed", [0, 7, -5, 2**31 - 1])
def test_counters_bits_and_uniforms_bitwise(seed):
    """The reference's counters over its padded [R, 128] view in [256, 128]
    tiles (base = pid 2n + seed golden, idx and idx + n) equal the port's
    per-element form; bits and uniforms are bitwise."""
    n_elems = 3 * 32768 + 1000                    # 4 tiles, the last ragged
    R = -(-n_elems // 128)
    e = np.arange(R * 128, dtype=np.uint64)
    pid, idx = e // 32768, e % 32768
    base = (pid * 2 * 32768 + (np.uint64(seed & 0xFFFFFFFF)
                               * np.uint64(0x9E3779B9))) & 0xFFFFFFFF
    want1 = ((base + idx) & 0xFFFFFFFF)[:n_elems]
    want2 = ((base + idx + 32768) & 0xFFFFFFFF)[:n_elems]
    ctr1, ctr2 = noise.perturb_counters(n_elems, seed)
    np.testing.assert_array_equal(ctr1.numpy().astype(np.uint64), want1)
    np.testing.assert_array_equal(ctr2.numpy().astype(np.uint64), want2)
    bits = noise.hash_bits(ctr1, seed)
    want_bits = np.asarray(_hash_bits(jnp.asarray(want1.astype(np.uint32)),
                                      jnp.int32(seed)))
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want_bits)
    np.testing.assert_array_equal(
        noise.uniform_from_bits(bits).numpy(),
        np.asarray(_uniform_from_bits(jnp.asarray(want_bits))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_sgd_update_matches_interpret_kernel(shape, jdt, tdt):
    P, G, p, g = _inputs(shape, jdt, tdt)
    want = ref_ops.sgd_update(P, G, 0.05)
    got = ops.sgd_update(p, g, 0.05)
    assert got.dtype == tdt and tuple(got.shape) == shape
    assert _ulp(_f32(got), _f32(want)).max() <= 1
    # and the reference's own oracle, at its tolerance
    np.testing.assert_allclose(
        _f32(got), _f32(ref_oracle.sgd_update_ref(P, G, 0.05)),
        rtol=1e-2 if tdt == torch.bfloat16 else 1e-6,
        atol=1e-2 if tdt == torch.bfloat16 else 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [7, -3])
def test_noise_within_ulp_bound_of_interpret_kernel(shape, seed):
    """sigma = s_noise = 1, s_sig = 0: xt is the kernel's raw normal."""
    P, G, p, g = _inputs(shape, jnp.float32, torch.float32, seed=1)
    kw = dict(gamma=0.05, sigma=1.0, s_sig=0.0, s_noise=1.0)
    _, want = ref_ops.dp_perturb(P, G, seed, **kw)
    _, got = ops.dp_perturb(p, g, seed, **kw)
    assert _ulp(_f32(got), _f32(want)).max() <= NOISE_ULP


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_dp_perturb_matches_interpret_kernel(shape, jdt, tdt):
    P, G, p, g = _inputs(shape, jdt, tdt, seed=2)
    kw = dict(gamma=0.1, sigma=1.3, s_sig=0.7, s_noise=1.3)
    wx, wxt = ref_ops.dp_perturb(P, G, 11, **kw)
    x, xt = ops.dp_perturb(p, g, 11, **kw)
    assert x.dtype == xt.dtype == tdt
    assert _ulp(_f32(x), _f32(wx)).max() <= 1
    got, want = _f32(xt), _f32(wxt)
    term = np.abs(want - np.float32(0.7) * _f32(wx))
    allowed = (NOISE_ULP * 2.0 ** -23 * term + 2.0 ** -23 * np.abs(want)
               + 2.0 ** -126)
    if tdt == torch.bfloat16:
        allowed = allowed + 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= allowed).all()


def test_noiseless_dp_perturb_scales_x_bitwise():
    P, G, p, g = _inputs((1000, 37), jnp.float32, torch.float32, seed=3)
    for sigma, s_noise in ((0.0, 1.3), (1.3, 0.0)):
        kw = dict(gamma=0.1, sigma=sigma, s_sig=0.7, s_noise=s_noise)
        np.testing.assert_array_equal(
            _f32(ops.dp_perturb(p, g, 5, **kw)[1]),
            _f32(ref_ops.dp_perturb(P, G, 5, **kw)[1]))


def test_noise_moments_and_seed_sensitivity():
    """The reference's moment check on the port: the residual xt - s_sig x
    has mean 0 and std sigma s_noise; another seed gives other noise."""
    shape = (512, 256)
    _, _, p, g = _inputs(shape, jnp.float32, torch.float32, seed=4)
    sigma, s_sig, s_noise = 2.0, 3.0, 1.5
    x, xt = ops.dp_perturb(p, g, 7, gamma=0.1, sigma=sigma, s_sig=s_sig,
                           s_noise=s_noise)
    resid = xt.double().numpy() - s_sig * x.double().numpy()
    assert abs(resid.mean()) < 5 * sigma * s_noise / np.sqrt(resid.size)
    assert resid.std() == pytest.approx(sigma * s_noise, rel=0.03)
    _, xt2 = ops.dp_perturb(p, g, 8, gamma=0.1, sigma=sigma, s_sig=s_sig,
                            s_noise=s_noise)
    assert float((xt - xt2).abs().max()) > 0.1


def test_plain_takes_the_cpu_and_counts_no_launch():
    p = torch.ones((4, 300)).expand(4, 300)
    before = (ops.sgd_update.launches, ops.dp_perturb.launches)
    x = ops.sgd_update(p, torch.ones((4, 300)), 0.5)
    ops.dp_perturb(p, p, 1, gamma=0.5, sigma=1.0, s_sig=1.0, s_noise=1.0)
    assert (ops.sgd_update.launches, ops.dp_perturb.launches) == before
    torch.testing.assert_close(x, torch.full((4, 300), 0.5))
    torch.testing.assert_close(
        dp_perturb_plain(p, p, 1, gamma=0.5, sigma=0.0, s_sig=2.0,
                         s_noise=1.0)[1], torch.ones((4, 300)))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_sgd_update_leaves_is_the_per_leaf_update(jdt, tdt):
    """The one-launch local step over dwfl-paper's leaves: on the CPU its
    plain version, bitwise the per-leaf sgd_update, and within 1 ULP of
    the reference's tree_map(sgd_update) (the interpret-mode kernel)."""
    leaves = [_inputs(shape, jdt, tdt, seed=i) for i, shape in enumerate(MLP_LEAVES)]
    ps, gs = [l[2] for l in leaves], [l[3] for l in leaves]
    before = (ops.sgd_update_leaves.launches, ops.sgd_update.launches)
    got = ops.sgd_update_leaves(ps, gs, 0.05)
    assert (ops.sgd_update_leaves.launches, ops.sgd_update.launches) == before
    want = jax.tree_util.tree_map(lambda P, G: ref_ops.sgd_update(P, G, 0.05),
                                  [l[0] for l in leaves], [l[1] for l in leaves])
    assert len(got) == len(MLP_LEAVES)
    for x, p, g, w in zip(got, ps, gs, want):
        assert x.dtype == tdt and x.shape == p.shape and x.is_contiguous()
        assert torch.equal(x, ops.sgd_update(p, g, 0.05))
        assert _ulp(_f32(x), _f32(w)).max() <= 1


def test_sgd_update_leaves_refuses_mismatched_lists():
    p = torch.zeros((4, 8))
    assert ops.sgd_update_leaves([], [], 0.1) == []
    with pytest.raises(ValueError, match="2 parameter leaves, 1 gradient"):
        ops.sgd_update_leaves([p, p], [p], 0.1)


def test_launch_plan_layout_and_refusals():
    """The launch's per-layout plan (metadata only, so it runs here): the
    outputs' views are contiguous, shaped like p, and start on 16-byte
    boundaries of one allocation; an expand()ed operand asks for a copy;
    a float64 leaf, a g shaped unlike its p and leaves of two dtypes are
    refused."""
    spec = lambda t: (t.shape, t.dtype, t.device, t.is_contiguous())
    for dtype in (torch.float32, torch.bfloat16):
        ps = [torch.zeros(s, dtype=dtype) for s in [(7,), (3, 5), (2, 2, 3)]]
        plan = ops._plan(tuple(map(spec, ps)), tuple(map(spec, ps)))
        assert plan.count == 3 and not plan.copy
        assert list(plan.ns) == [7, 15, 12]
        buf = torch.empty(plan.total, dtype=dtype)
        for (shape, stride, offset), nbytes, p in zip(plan.views,
                                                      plan.x_bytes, ps):
            view = buf.as_strided(shape, stride, offset)
            assert view.shape == p.shape and view.is_contiguous()
            assert nbytes == offset * p.element_size() and nbytes % 16 == 0
        assert plan.total >= plan.views[-1][2] + 12
    p = torch.zeros((4, 300))
    wide = torch.ones((4, 1)).expand(4, 300)
    assert ops._plan((spec(p),), (spec(wide),)).copy
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops._plan((spec(p.double()),), (spec(p.double()),))
    with pytest.raises(ValueError, match="operand g"):
        ops._plan((spec(p),), (spec(p.T),))
    with pytest.raises(ValueError, match="one dtype and device"):
        ops._plan((spec(p), spec(p.bfloat16())), (spec(p), spec(p.bfloat16())))
