"""The CUDA kernels (dp_mix, dp_perturb, flash_attention, ssd_scan) against
their plain PyTorch versions on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips without one. On a machine with a card and nvcc but no JAX
(tests/conftest.py imports JAX, so it is left out):
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py``.
Tolerance as in chip_smoke.py: both sum N float32 products in different
orders, so |kernel - plain| <= (N + 8) * 2^-23 * scale, scale = max|x| +
5.42 max|n/c| + 5.42 max|m_scale sigma_m|; a bfloat16 output may land one
bfloat16 step (2^-7 of its magnitude) further. dp_perturb: x within 1
ULP (the plain version's fused multiply-add goes through float64 and may
round twice; sgd_update_leaves bitwise the per-leaf kernel), the noisy xt
within 4 ULP of its noise term plus 2 ULP of itself, and a bfloat16
output one bfloat16 step further. flash_attention:
both compute in float32 and sum in other orders, so within 2e-5 (the
reference's float32 tolerance for its kernel), a bfloat16 output one
bfloat16 step further (the bfloat16 kernel runs on the tensor cores:
exact products of q k^T, P v as P_hi + P_lo, a residual of 2^-17 |P|). ssd_scan: rtol 1e-4 / atol 1e-5 on y, the states
and the decays (the reference's tolerance for its kernel against its
oracle; both take cs in the reference's float32 order), a bfloat16 y one
bfloat16 step further. The sparse dp_mix round (dp_mix_prep +
dp_mix_gather): the same tolerance with the mix's k + 1 terms in place of
N; with zero weights bitwise the dense kernel's round. dp_mix's replicate
axis (a stack of R rounds in one launch): each replicate bitwise the
launch of its own operands, on both routes, and the whole within the
plain twin's tolerance above, replicate by replicate. A reduced olmo-1b
round, flat and tree, on the card against the CPU within 1e-4 (1 +
max|out|), and C2's refusal of olmo-1b's full-depth flat buffer at N =
2."""
import pytest
import torch

from repro_torch.core import exchange as X
from repro_torch.core.channel import ChannelConfig
from repro_torch.kernels.dp_mix import ops
from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain, dp_mix_sparse_plain
from repro_torch.kernels.dp_perturb import ops as dp_ops
from repro_torch.kernels.dp_perturb.dp_perturb import dp_perturb_plain
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_plain

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _plan(kind: str, N: int, chan):
    """A MixPlan on the card: the complete graph, gossip, a ring, sampled
    participation (half the workers sending, so half of self_scale is 0)
    or a dynamic round (iot_dense's radio range over positions drawn from
    a seed, worker 1 churned out and the last worker out of range: two
    identity rows of W with listen = 0, a Metropolis W elsewhere)."""
    from repro_torch.core import protocol as P
    from repro_torch.net import fading, geometry, scenarios
    if kind in ("complete", "gossip"):
        return (X.plan_complete if kind == "complete" else X.plan_gossip)(
            None, chan, "cuda")
    if kind == "ring":
        return X.plan_topology(P.ProtocolConfig(n_workers=N, topology="ring"),
                               chan, "cuda")
    if kind == "sampled":
        return X.plan_sampled(None, chan, "cuda",
                              torch.arange(N, device="cuda") % 2 == 0)
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
    return X.plan_dynamic(None, tr.to("cuda"), "cuda", W.cuda())


# (50, 1001) and (51, 1001): the largest N of the column route on an H100
# (its shared memory opted in past 48 KiB) and the first of the large-N
# route. The ring, sampled and dynamic plans bring what the complete graph
# never gives: a sparse W with a per-receiver m_scale, a self_scale of 0
# for the workers that did not send, and identity rows of W with listen =
# 0, whose outputs must be p - gamma g (within 1 ULP of the plain twin's).
@pytest.mark.parametrize("N,d", [(10, 5000), (3, 130), (64, 1000),
                                 (65, 1001), (128, 777), (256, 333),
                                 (50, 1001), (51, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["complete", "gossip", "ring", "sampled",
                                  "dynamic"])
def test_kernel_matches_plain(N, d, dtype, kind):
    _need_card()
    chan = ChannelConfig(n_workers=N, p_dbm=30.0, sigma=0.7, sigma_m=0.4,
                         seed=N).realize()
    plan = _plan(kind, N, chan)
    noisy = plan.noisy
    gen = torch.Generator(device="cuda").manual_seed(d)
    p = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    g = (0.2 * torch.randn((N, d), generator=gen, device="cuda")).to(dtype)
    seed, col0 = (torch.tensor([v], dtype=torch.int32, device="cuda")
                  for v in (77, 256))
    c = plan.c.reshape(())
    ones = torch.ones(N, device="cuda")
    vec = lambda v: ones if v is None else v
    args = (p, g, seed, col0, torch.stack([c, plan.sigma_m.reshape(())]),
            plan.amp, vec(plan.self_scale), plan.m_scale, vec(plan.listen),
            plan.W.contiguous())
    kw = dict(gamma=0.05, eta=0.4, noisy=noisy, counter_width=8192)
    before = ops.dp_mix_round.launches
    out = ops._launch(*args, **kw)
    assert ops.dp_mix_round.launches == before + 1
    ref = dp_mix_plain(*args, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == p.shape
    k32, r32 = out.float(), ref.float()
    x = p.float() - 0.05 * g.float()
    scale = float(x.abs().max())
    if noisy:
        scale += 5.42 * float((plan.amp / c).abs().max()
                              + (plan.m_scale * plan.sigma_m).abs().max())
    allowed = (N + 8) * 2.0 ** -23 * scale
    if dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -7 * torch.maximum(k32.abs(), r32.abs())
    assert bool(((k32 - r32).abs() <= allowed).all())
    if plan.listen is not None:
        idle = plan.listen == 0
        assert bool(idle.any())
        ulps = (k32[idle].view(torch.int32).long()
                - r32[idle].view(torch.int32).long()).abs()
        assert int(ulps.max()) <= (1 << 16 if dtype == torch.bfloat16 else 1)


def _stack_args(R, N, d, dtype):
    """R rounds' operands on the card: random p, g, a row-stochastic W
    with an identity row (listen 0) in replicate 0, amplitudes, c,
    sigma_m and seeds of their own."""
    gen = torch.Generator(device="cuda").manual_seed(R * 1000 + N)
    dev = "cuda"
    p = torch.randn((R, N, d), generator=gen, device=dev).to(dtype)
    g = (0.2 * torch.randn((R, N, d), generator=gen, device=dev)).to(dtype)
    W = torch.softmax(torch.randn((R, N, N), generator=gen, device=dev), -1)
    listen = torch.ones((R, N), device=dev)
    W[0, 0] = torch.nn.functional.one_hot(torch.tensor(0), N).float()
    listen[0, 0] = 0.0
    amp = torch.rand((R, N), generator=gen, device=dev)
    c = torch.rand((R,), generator=gen, device=dev) + 0.5
    sm = torch.rand((R,), generator=gen, device=dev)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (R,), generator=gen, device=dev,
                          dtype=torch.int32)
    return p, g, seeds, W, amp, c, sm, listen


# (50, 1001) and (51, 1001): the column route's last N on an H100 and the
# large-N route's first
@pytest.mark.parametrize("R,N,d", [(3, 10, 5000), (2, 3, 130), (2, 50, 1001),
                                   (2, 51, 1001), (3, 64, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_replicate_axis_is_r_separate_launches(R, N, d, dtype, noisy):
    _need_card()
    p, g, seeds, W, amp, c, sm, listen = _stack_args(R, N, d, dtype)
    kw = dict(gamma=0.05, eta=0.4, noisy=noisy)
    before = ops.dp_mix_round.launches
    out = ops.dp_mix_round(p, g, seeds, W, amp, c, sm, listen=listen, **kw)
    assert ops.dp_mix_round.launches == before + 1
    for r in range(R):
        one = ops.dp_mix_round(p[r], g[r], seeds[r], W[r], amp[r], c[r],
                               sm[r], listen=listen[r], **kw)
        assert torch.equal(out[r], one), r
        vecs = ops._round_vectors(N, p.device, seeds[r], 0, amp[r], c[r],
                                  sm[r], None, None, listen[r])
        ref = dp_mix_plain(p[r], g[r], *vecs, W[r], counter_width=ops._roundup(
            d, ops.LANES), **kw)
        k32, r32 = out[r].float(), ref.float()
        x = p[r].float() - 0.05 * g[r].float()
        scale = float(x.abs().max()) + (
            5.42 * float((amp[r] / c[r]).abs().max() + sm[r] / (c[r] * (N - 1)))
            if noisy else 0.0)
        allowed = (N + 8) * 2.0 ** -23 * scale
        if dtype == torch.bfloat16:
            allowed = allowed + 2.0 ** -7 * torch.maximum(k32.abs(), r32.abs())
        assert bool(((k32 - r32).abs() <= allowed).all()), r
    torch.cuda.synchronize()


def test_fleet_flat_round_is_one_launch_and_sync_free():
    _need_card()
    import dataclasses
    from repro_torch.configs import DWFL_PAPER
    from repro_torch.core import protocol as P
    from repro_torch.data import (ClassificationStore, classification_dataset,
                                  dirichlet_partition)
    from repro_torch.fleet import FleetEngine
    from repro_torch.obs import no_implicit_transfers
    cfg = dataclasses.replace(DWFL_PAPER, d_model=32)
    proto = P.ProtocolConfig(n_workers=6, gamma=0.01, eta=0.4,
                             target_epsilon=1.0, channel_model="dynamic",
                             scenario="vehicular")
    x, y = classification_dataset(600, seed=0)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, 6), 8,
                                      "cuda")
    from repro_torch.core import trajectory as TJ
    fleet = FleetEngine(proto, 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat, spec = fleet.init_flat_spec(gen, cfg)
    body = TJ.make_round_body(cfg, proto, store, spec, "cuda", fleet=fleet)
    carry = TJ.TrajCarry(gen, flat, fleet.init(gen))
    carry, _ = TJ.run_chunk(body, carry, 2)          # warm: the library
    before = ops.dp_mix_round.launches
    with no_implicit_transfers(True, "cuda"):
        carry, out = TJ.run_chunk(body, carry, 3)
    assert ops.dp_mix_round.launches == before + 3
    assert bool(torch.isfinite(carry.params).all())
    assert out["metrics"]["loss"].shape == (3, 4)


def _sparse_args(N, d, k, dtype, seed):
    """A sparse round's operands on the card: a capped unit-disk list over
    seeded positions (~8 in-disk neighbors, so some rows fill all k slots
    and some are empty), random p, g and vectors, listen = 0 on the empty
    rows, as plan_dynamic_sparse gives it."""
    from repro_torch.net import geometry
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pos = torch.rand((N, 2), generator=gen, device="cuda") * 100.0
    pos[0] = 1e4                                    # one isolated worker
    r = 100.0 * (8.0 / (3.14159 * N)) ** 0.5
    sw = geometry.sparse_metropolis(
        geometry.GeometryConfig(area=100.0, comm_radius=r), pos, k,
        block=max(1, N // 3))
    p = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    g = (0.2 * torch.randn((N, d), generator=gen, device="cuda")).to(dtype)
    amp = torch.rand(N, generator=gen, device="cuda") + 0.5
    mscale = 0.3 * torch.rand(N, generator=gen, device="cuda")
    seed_t, col0 = (torch.tensor([v], dtype=torch.int32, device="cuda")
                    for v in (77, 256))
    args = (p, g, seed_t, col0, torch.tensor([2.0, 0.3], device="cuda"), amp,
            torch.ones(N, device="cuda"), mscale,
            (sw.off_degree() > 0).float(), sw.idx.contiguous(),
            sw.w.contiguous(), sw.self_w.contiguous())
    return args, amp, mscale


@pytest.mark.parametrize("N,d,k", [(8, 40, 2), (10, 5000, 4), (64, 1000, 12),
                                   (130, 5003, 12), (2048, 3001, 12),
                                   (33, 70001, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_sparse_kernel_matches_plain(N, d, k, dtype, noisy):
    _need_card()
    args, amp, mscale = _sparse_args(N, d, k, dtype, N + d)
    kw = dict(gamma=0.05, eta=0.4, noisy=noisy, counter_width=80000)
    before = ops.dp_mix_round_sparse.launches
    out = ops._launch_sparse(*args, **kw)
    assert ops.dp_mix_round_sparse.launches == before + 1
    ref = dp_mix_sparse_plain(*args, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == args[0].shape
    k32, r32 = out.float(), ref.float()
    x = args[0].float() - 0.05 * args[1].float()
    scale = float(x.abs().max())
    if noisy:
        scale += 5.42 * float((amp / 2.0).abs().max()
                              + (mscale * 0.3).abs().max())
    allowed = (k + 1 + 8) * 2.0 ** -23 * scale
    if dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -7 * torch.maximum(k32.abs(), r32.abs())
    assert bool(((k32 - r32).abs() <= allowed).all())
    idle = args[8] == 0
    assert bool(idle.any())
    ulps = (k32[idle].view(torch.int32).long()
            - r32[idle].view(torch.int32).long()).abs()
    assert int(ulps.max()) <= (1 << 16 if dtype == torch.bfloat16 else 1)


@pytest.mark.parametrize("N,d", [(10, 5000), (64, 1001), (200, 3000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_kernel_with_zero_weights_is_the_dense_kernel(N, d, dtype):
    """Every slot weight and self_w 0: the sparse round is v alone,
    bitwise the dense kernel's round with W = 0 (either route), and
    through the wrapper (the padded rows of N = 10 too)."""
    _need_card()
    args, amp, mscale = _sparse_args(N, d, 4, dtype, 3)
    args = args[:10] + (torch.zeros_like(args[10]),
                        torch.zeros_like(args[11]))
    kw = dict(gamma=0.05, eta=0.4, noisy=True, counter_width=8192)
    sparse = ops._launch_sparse(*args, **kw)
    dense = ops._launch(*args[:9], torch.zeros((N, N), device="cuda"), **kw)
    torch.cuda.synchronize()
    bits = lambda a: a.contiguous().view(torch.int16 if a.dtype ==
                                         torch.bfloat16 else torch.int32)
    assert torch.equal(bits(sparse), bits(dense))
    from repro_torch.net.sparse import SparseW
    sw = SparseW(args[9], args[10], args[11])
    wrapped = ops.dp_mix_round_sparse(
        args[0], args[1], 77, sw, amp, 2.0, 0.3, gamma=0.05, eta=0.4,
        m_scale=mscale, listen=args[8], col0=256, counter_width=8192)
    assert torch.equal(bits(wrapped), bits(dense))


def test_wrapper_limits_on_the_card():
    """N = 65, past the old limit of 64, runs and matches the plain version
    (one count); C2's counter limit and a dtype the kernel has no
    instantiation for still raise."""
    _need_card()
    N, d = 65, 300
    chan = ChannelConfig(n_workers=N, p_dbm=30.0, sigma=0.7, sigma_m=0.4,
                         seed=N).realize()
    plan = X.plan_complete(None, chan, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(d)
    p = torch.randn((N, d), generator=gen, device="cuda")
    g = 0.2 * torch.randn((N, d), generator=gen, device="cuda")
    before = ops.dp_mix_round.launches
    out = ops.dp_mix_round_plan(p, g, 5, plan, gamma=0.05, eta=0.4)
    assert ops.dp_mix_round.launches == before + 1
    want = ops.dp_mix_round_plan(p.cpu(), g.cpu(), 5, X.plan_complete(
        None, chan, "cpu"), gamma=0.05, eta=0.4)
    x = p.cpu() - 0.05 * g.cpu()
    scale = float(x.abs().max()) + 5.42 * float(
        (plan.amp / plan.c).abs().max() + (plan.m_scale * plan.sigma_m).abs().max())
    assert float((out.cpu() - want).abs().max()) <= (N + 8) * 2.0 ** -23 * scale
    z = torch.zeros((3, 8), device="cuda")
    with pytest.raises(ValueError, match="2\\^31"):
        ops.dp_mix_round(z, z, 0, torch.eye(3), torch.ones(3), 1.0, 0.0,
                         gamma=0.1, eta=0.5, counter_width=1 << 30)
    with pytest.raises(TypeError):
        q = torch.zeros((4, 8), device="cuda", dtype=torch.float64)
        ops.dp_mix_round(q, q, 0, torch.eye(4), torch.ones(4), 1.0, 0.0,
                         gamma=0.1, eta=0.5)


@pytest.mark.parametrize("N", [10, 128])
def test_noise_fields_bitwise(N):
    """Both noise fields through the kernel (both routes: the column route
    at N = 10, the large-N route at 128), bitwise the plain version's: p =
    g = 0, W = I, amp = c = 1, self = m_scale = 0, eta = listen = 1 gives
    out = Gn; W = 0, amp = self = 0, m_scale = sigma_m = 1 gives out =
    Gm."""
    _need_card()
    from repro_torch.kernels import noise
    d = 1001
    zeros = torch.zeros((N, d), device="cuda")
    seed, col0 = (torch.tensor([v], dtype=torch.int32, device="cuda")
                  for v in (4321, 384))
    one, zero = torch.ones(N, device="cuda"), torch.zeros(N, device="cuda")
    scal = torch.ones(2, device="cuda")
    kw = dict(gamma=0.0, eta=1.0, noisy=True, counter_width=2048)
    gn, gm = noise.normal_pair_hash((N, d), 2048, 384, 4321, device="cuda")
    bits = lambda t: t.contiguous().view(torch.int32)
    for field, amp, ms, W in ((gn, one, zero, torch.eye(N, device="cuda")),
                              (gm, zero, one, torch.zeros((N, N),
                                                          device="cuda"))):
        args = (zeros, zeros, seed, col0, scal, amp, zero, ms, one, W)
        out = ops._launch(*args, **kw)
        ref = dp_mix_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(bits(ref), bits(field))
        assert torch.equal(bits(out), bits(ref))


def _ulp(a, b):
    ia, ib = (t.float().contiguous().view(torch.int32).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("shape", [(10, 256), (3, 70001), (10, 256, 10),
                                   (5,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noisy", [True, False])
def test_dp_perturb_kernel_matches_plain(shape, dtype, noisy):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    p = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    kw = dict(gamma=0.05, sigma=1.0 if noisy else 0.0, s_sig=0.7,
              s_noise=1.3)
    before = dp_ops.dp_perturb.launches
    x, xt = dp_ops.dp_perturb(p, g, 99, **kw)
    assert dp_ops.dp_perturb.launches == before + 1
    rx, rxt = dp_perturb_plain(p, g, 99, **kw)
    torch.cuda.synchronize()
    assert x.dtype == xt.dtype == dtype and x.shape == xt.shape == p.shape
    step = (lambda a, b: 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
            if dtype == torch.bfloat16 else 0.0)
    k, r = x.float(), rx.float()
    assert bool(((_ulp(k, r) <= 1) | ((k - r).abs() <= step(k, r))).all())
    k, r = xt.float(), rxt.float()
    term = (r - 0.7 * rx.float()).abs()
    allowed = (4 * 2.0 ** -23 * term + 2 * 2.0 ** -23 * r.abs() + 2.0 ** -126
               + step(k, r))
    assert bool(((k - r).abs() <= allowed).all())


def test_sgd_update_counts_launches_and_reads_each_worker():
    """An expand()ed stride-0 operand is made contiguous before the launch:
    every worker's row comes out of its own memory."""
    _need_card()
    p = torch.arange(4.0, device="cuda").reshape(4, 1).expand(4, 300)
    g = torch.ones((4, 300), device="cuda")
    before = dp_ops.sgd_update.launches
    x = dp_ops.sgd_update(p, g, 0.5)
    assert dp_ops.sgd_update.launches == before + 1
    torch.testing.assert_close(x, p - 0.5, rtol=0, atol=0)
    with pytest.raises(TypeError):
        dp_ops.sgd_update(p.double(), g.double(), 0.5)


def _leaves(dtype, shapes, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return [rnd(s) for s in shapes], [rnd(s) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgd_update_leaves_is_one_launch_bitwise_per_leaf(dtype):
    """dwfl-paper's six leaves at N = 10, leaves of odd length and one
    whose pointer is not 16 bytes aligned (a view one element into its
    buffer): one launch, each leaf bitwise the per-leaf kernel (a table
    of one entry) and within 1 ULP of the plain version (a bfloat16
    output one bfloat16 step)."""
    _need_card()
    shapes = [(10, 256), (10, 3072, 256), (10, 256), (10, 256, 256), (10, 10),
              (10, 256, 10), (7,), (3, 1001)]
    ps, gs = _leaves(dtype, shapes + [(1 + 4099,)], 3)
    ps[-1], gs[-1] = ps[-1][1:], gs[-1][1:]
    assert ps[-1].data_ptr() % 16 != 0
    before = (dp_ops.sgd_update_leaves.launches, dp_ops.sgd_update.launches)
    xs = dp_ops.sgd_update_leaves(ps, gs, 0.05)
    assert dp_ops.sgd_update_leaves.launches == before[0] + 1
    assert dp_ops.sgd_update.launches == before[1]
    ones = [dp_ops.sgd_update(p, g, 0.05) for p, g in zip(ps, gs)]
    plain = dp_ops.sgd_update_leaves_plain(ps, gs, 0.05)
    torch.cuda.synchronize()
    for x, one, r, p in zip(xs, ones, plain, ps):
        assert x.dtype == dtype and x.shape == p.shape and x.is_contiguous()
        assert torch.equal(x, one)
        k, r = x.float(), r.float()
        step = (2.0 ** -7 * torch.maximum(k.abs(), r.abs())
                if dtype == torch.bfloat16 else 0.0)
        assert bool(((_ulp(k, r) <= 1) | ((k - r).abs() <= step)).all())


def test_sgd_update_leaves_takes_sixteen_leaves_a_launch():
    _need_card()
    ps, gs = _leaves(torch.float32, [(5, 33)] * 20, 4)
    before = dp_ops.sgd_update_leaves.launches
    xs = dp_ops.sgd_update_leaves(ps, gs, 0.5)
    assert dp_ops.sgd_update_leaves.launches == before + 2
    for x, p, g in zip(xs, ps, gs):
        assert torch.equal(x, dp_ops.sgd_update(p, g, 0.5))
    # a second call over the same layout reuses the plan, not the memory
    again = dp_ops.sgd_update_leaves(ps, gs, 0.25)
    assert {x.data_ptr() for x in again}.isdisjoint(x.data_ptr() for x in xs)
    for x, p, g in zip(again, ps, gs):
        assert torch.equal(x, dp_ops.sgd_update(p, g, 0.25))


# tests/test_kernels.py::test_flash_attention_sweep's cases, then head_dim
# 128 (olmo, glm4) and 256 (gemma) with ragged S and a window; then cases
# off the float32 kernel's tiles (64 query rows, 16 a warp, 64 keys, 8-key
# blocks): a GQA group of 8 at every head_dim, S under one tile and not a
# multiple of 8, windows that end inside an 8-key block, a group of 3
FLASH_CASES = [
    (2, 256, 4, 2, 64, None),
    (1, 256, 4, 1, 64, 96),
    (2, 128, 2, 2, 32, None),
    (1, 512, 8, 4, 64, None),
    (2, 300, 4, 4, 128, None),
    (1, 520, 8, 1, 256, None),
    (1, 300, 8, 1, 256, 100),
    (1, 256, 8, 1, 32, None),
    (2, 200, 8, 1, 64, 50),
    (1, 1000, 16, 16, 128, None),
    (2, 384, 8, 1, 256, 128),
    (1, 77, 4, 4, 128, None),
    (1, 130, 6, 2, 64, 41),
]


@pytest.mark.parametrize("B,S,H,Hkv,hd,win", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(B, S, H, Hkv, hd, win, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(S + hd)
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda").to(dtype)
               for n in (H, Hkv, Hkv))
    before = fa_ops.flash_attention.launches
    o = fa_ops.flash_attention(q, k, v, causal=True, sliding_window=win)
    assert fa_ops.flash_attention.launches == before + 1
    r = flash_attention_plain(q, k, v, causal=True, sliding_window=win)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    a, b = o.float(), r.float()
    allowed = 2e-5 + 2e-5 * b.abs()
    if dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
    assert bool(((a - b).abs() <= allowed).all())


@pytest.mark.parametrize("B,S,H,Hkv,hd", [(4, 1024, 8, 1, 256),
                                           (4, 1024, 16, 16, 128)],
                         ids=["gemma-2b", "olmo-1b"])
def test_flash_attention_bf16_at_the_serve_shapes(B, S, H, Hkv, hd):
    """The tensor-core kernel at gemma-2b's and olmo-1b's prefill of 4
    prompts of 1024 tokens, at the same tolerance."""
    test_flash_attention_kernel_matches_plain(B, S, H, Hkv, hd, None,
                                              torch.bfloat16)


def test_flash_attention_bf16_reads_strided_views():
    """q, k, v as views into one fused [B, S, (H + 2 Hkv) hd] projection:
    the tensor maps read them through their strides, no copy."""
    _need_card()
    B, S, H, Hkv, hd = 2, 200, 4, 2, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((B, S, (H + 2 * Hkv) * hd), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q = qkv[..., :H * hd].unflatten(-1, (H, hd))
    k = qkv[..., H * hd:(H + Hkv) * hd].unflatten(-1, (Hkv, hd))
    v = qkv[..., (H + Hkv) * hd:].unflatten(-1, (Hkv, hd))
    assert not q.is_contiguous()
    o = fa_ops.flash_attention(q, k, v, causal=True)
    r = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    torch.cuda.synchronize()
    a, b = o.float(), r.float()
    allowed = 2e-5 + 2e-5 * b.abs() + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
    assert bool(((a - b).abs() <= allowed).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_flash_attention_reads_strided_views(dtype, offset):
    """q, k, v as views into one fused [B, S, (H + 2 Hkv) hd] projection,
    read through their strides; a view one element into its buffer is
    not 16-byte aligned and is copied first. Either way within tolerance."""
    _need_card()
    B, S, H, Hkv, hd = 2, 200, 8, 1, 128
    gen = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn((B, S, offset + (H + 2 * Hkv) * hd), generator=gen,
                      device="cuda").to(dtype)[..., offset:]
    q = qkv[..., :H * hd].unflatten(-1, (H, hd))
    k = qkv[..., H * hd:(H + Hkv) * hd].unflatten(-1, (Hkv, hd))
    v = qkv[..., (H + Hkv) * hd:].unflatten(-1, (Hkv, hd))
    assert fa_ops._readable(q) == (offset == 0)
    o = fa_ops.flash_attention(q, k, v, causal=True)
    r = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    torch.cuda.synchronize()
    a, b = o.float(), r.float()
    allowed = 2e-5 + 2e-5 * b.abs()
    if dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
    assert bool(((a - b).abs() <= allowed).all())


def test_prefill_with_use_pallas_launches_once_per_layer():
    """A reduced gemma-2b prefill with use_pallas=True launches the kernel
    once per layer and agrees with the CPU's (plain) prefill."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    cfg = get_arch("gemma-2b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    want, _ = M.prefill(params, {"tokens": toks}, cfg, use_pallas=True)
    _need_card()
    dev = X.tree_map(lambda t: t.cuda(), params)
    before = fa_ops.flash_attention.launches
    got, cache = M.prefill(dev, {"tokens": toks.cuda()}, cfg, use_pallas=True)
    assert fa_ops.flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_flash_wrapper_refuses_on_the_card():
    _need_card()
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(z(1, 16, 4, 48), z(1, 16, 2, 48), z(1, 16, 2, 48))
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(z(1, 16, 6, 64), z(1, 16, 4, 64), z(1, 16, 4, 64))
    with pytest.raises(TypeError):
        d = torch.float64
        fa_ops.flash_attention(z(1, 16, 4, 64, dt=d), z(1, 16, 2, 64, dt=d),
                               z(1, 16, 2, 64, dt=d))


# ssd_scan (B, S, H, P, N, chunk): the reference's sweep, H < 8, S equal to
# the chunk, chunk 256 with N = P = 128, and zamba2-7b's heads; then cases
# off the kernel's tiles (64 query rows, 16-key product tiles, 8 x 8
# register tiles, heads in flight fy and fst): chunks that are no multiple
# of 16 or 64, N and P of 16, 32 and 128 apart and together, H < 8,
# zamba2-7b's 112 heads at B = 1, and P and N that are no multiple of 8 or
# of 4 (the kernel's element-by-element loads and stores)
SSD_CASES = [
    (2, 128, 8, 16, 16, 32),
    (1, 256, 16, 32, 64, 64),
    (2, 64, 8, 64, 64, 32),
    (2, 192, 4, 64, 64, 64),
    (1, 96, 1, 48, 24, 96),
    (1, 512, 8, 128, 128, 256),
    (2, 256, 112, 64, 64, 128),
    (1, 120, 8, 32, 32, 24),
    (2, 200, 4, 16, 16, 100),
    (1, 256, 112, 64, 64, 128),
    (1, 256, 8, 128, 128, 128),
    (2, 96, 2, 20, 18, 48),
    (1, 128, 8, 128, 16, 64),
    (1, 64, 8, 16, 128, 32),
]


def _ssd_inputs(B, S, H, P, N, dtype, dt_scale=1.0):
    gen = torch.Generator(device="cuda").manual_seed(S + H + N)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = (0.5 * rnd(B, S, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, H)) * dt_scale
    A = -torch.exp(0.3 * rnd(H))
    Bm, Cm = ((0.3 * rnd(B, S, N)).to(dtype) for _ in range(2))
    return x, dt, dt * A, Bm, Cm


def _ssd_close(got, want, bf16):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        allowed = 1e-5 + 1e-4 * b.abs()
        if i == 0 and bf16:
            allowed = allowed + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
        assert bool(((a - b).abs() <= allowed).all())


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(B, S, H, P, N, chunk, dtype):
    _need_card()
    x, dt, dA, Bm, Cm = _ssd_inputs(B, S, H, P, N, dtype)
    before = ssd_ops.ssd_intra_chunk.launches
    got = ssd_ops.ssd_intra_chunk(x, dt, dA, Bm, Cm, chunk=chunk)
    assert ssd_ops.ssd_intra_chunk.launches == before + 1
    want = ssd_intra_chunk_plain(x, dt, dA, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    _ssd_close(got, want, dtype == torch.bfloat16)


def test_ssd_scan_takes_the_kernels_cs():
    """ops.ssd_scan on the card takes cs from the kernel (its fourth
    output) and calls cumsum_f32 no time; y and the final state are
    bitwise those of the scan with cumsum_f32's cs."""
    _need_card()
    from repro_torch.kernels.ssd_scan.ssd_scan import cumsum_f32, inter_chunk
    B, S, H, P, N, chunk = 2, 256, 8, 64, 32, 128
    x, dt, _, Bm, Cm = _ssd_inputs(B, S, H, P, N, torch.float32)
    A = -torch.exp(torch.linspace(-1.0, 1.0, H, device="cuda"))
    calls = []
    orig = ssd_ops.cumsum_f32
    ssd_ops.cumsum_f32 = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        before = ssd_ops.ssd_intra_chunk.launches
        y, h = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        assert ssd_ops.ssd_intra_chunk.launches == before + 1
    finally:
        ssd_ops.cumsum_f32 = orig
    assert not calls
    dA = dt * A
    nc = S // chunk
    y_diag, st, cd = ssd_ops.ssd_intra_chunk(x, dt, dA, Bm, Cm, chunk=chunk)
    y_off, h_ref = inter_chunk(st, cd, cumsum_f32(dA.reshape(B, nc, chunk, H), 2),
                               Cm.reshape(B, nc, chunk, N))
    torch.cuda.synchronize()
    assert torch.equal(y, y_diag + y_off.reshape(B, S, H, P))
    assert torch.equal(h, h_ref)


def test_ssd_kernel_takes_any_batch():
    """B past 65,535 (a grid dimension's limit): the kernel's flat grid
    covers every batch row."""
    _need_card()
    x, dt, dA, Bm, Cm = _ssd_inputs(70_000, 4, 2, 16, 16, torch.float32)
    got = ssd_ops.ssd_intra_chunk(x, dt, dA, Bm, Cm, chunk=2)
    want = ssd_intra_chunk_plain(x, dt, dA, Bm, Cm, chunk=2)
    torch.cuda.synchronize()
    _ssd_close(got, want, False)


def test_ssd_kernel_masks_before_the_exp():
    """A fast decay (|dA| up to ~200 a step): above the diagonal cs_i - cs_j
    overflows exp; the kernel's outputs stay finite and equal the plain
    version's."""
    _need_card()
    x, dt, dA, Bm, Cm = _ssd_inputs(1, 256, 8, 64, 64, torch.float32, dt_scale=40.0)
    got = ssd_ops.ssd_intra_chunk(x, dt, dA, Bm, Cm, chunk=128)
    want = ssd_intra_chunk_plain(x, dt, dA, Bm, Cm, chunk=128)
    torch.cuda.synchronize()
    _ssd_close(got, want, False)


def test_ssd_kernel_reads_the_models_strided_views():
    """x, Bm and Cm as the Mamba2 block hands them over: views into one
    [B, S, d_inner + 2N] conv output, read through their strides."""
    _need_card()
    B, S, H, P, N = 2, 128, 8, 64, 32
    gen = torch.Generator(device="cuda").manual_seed(11)
    xBC = 0.4 * torch.randn((B, S, H * P + 2 * N), generator=gen, device="cuda")
    x = xBC[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xBC[..., H * P:H * P + N], xBC[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device="cuda"))
    dA = dt * -1.5
    got = ssd_ops.ssd_intra_chunk(x, dt, dA, Bm, Cm, chunk=64)
    want = ssd_intra_chunk_plain(x.contiguous(), dt, dA, Bm.contiguous(),
                                 Cm.contiguous(), chunk=64)
    torch.cuda.synchronize()
    _ssd_close(got, want, False)


@pytest.mark.parametrize("offset", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_unaligned_views(offset, dtype):
    """x, Bm and Cm whose base lies ``offset`` elements into their storage:
    the launch loads rows 4 elements at a time only where the base is
    aligned to 4 elements, and element by element otherwise."""
    _need_card()
    B, S, H, P, N = 2, 128, 8, 32, 16
    x, dt, dA, Bm, Cm = _ssd_inputs(B, S, H, P, N, dtype)
    shift = lambda t: torch.cat([t.new_zeros(offset), t.flatten()])[offset:].view(t.shape)
    x, Bm, Cm = shift(x), shift(Bm), shift(Cm)
    assert x.data_ptr() % (4 * x.element_size()) == (offset % 4) * x.element_size()
    got = ssd_ops.ssd_intra_chunk(x, dt, dA, Bm, Cm, chunk=64)
    want = ssd_intra_chunk_plain(x, dt, dA, Bm, Cm, chunk=64)
    torch.cuda.synchronize()
    _ssd_close(got, want, dtype == torch.bfloat16)


def test_hybrid_prefill_launches_once_per_mamba_layer():
    """A reduced zamba2 (n_super 2, n_rem 1) prefill with use_pallas=True
    launches ssd_scan once per Mamba2 layer and flash_attention never, and
    agrees with the CPU's (plain) prefill."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    cfg = get_arch("zamba2-7b").reduced(num_layers=5)
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    want, _ = M.prefill(params, {"tokens": toks}, cfg, use_pallas=True)
    _need_card()
    dev = X.tree_map(lambda t: t.cuda(), params)
    before = ssd_ops.ssd_intra_chunk.launches
    flash_before = fa_ops.flash_attention.launches
    got, cache = M.prefill(dev, {"tokens": toks.cuda()}, cfg, use_pallas=True)
    assert ssd_ops.ssd_intra_chunk.launches == before + cfg.num_layers
    assert fa_ops.flash_attention.launches == flash_before
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_ssd_wrapper_refuses_on_the_card():
    _need_card()
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device="cuda")
    with pytest.raises(ValueError, match="chunk 512 outside"):
        ssd_ops.ssd_intra_chunk(z(1, 512, 8, 64), z(1, 512, 8), z(1, 512, 8),
                                z(1, 512, 16), z(1, 512, 16), chunk=512)
    with pytest.raises(ValueError, match="N = 160"):
        ssd_ops.ssd_intra_chunk(z(1, 64, 8, 64), z(1, 64, 8), z(1, 64, 8),
                                z(1, 64, 160), z(1, 64, 160), chunk=64)
    with pytest.raises(ValueError, match="H = 12"):
        ssd_ops.ssd_intra_chunk(z(1, 64, 12, 64), z(1, 64, 12), z(1, 64, 12),
                                z(1, 64, 16), z(1, 64, 16), chunk=64)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssd_ops.ssd_scan(z(1, 96, 8, 64), z(1, 96, 8), z(8), z(1, 96, 16),
                         z(1, 96, 16), chunk=64)


# ---------------------------------------------------------------------------
# sharding (repro_torch.shard): B1's column windows and row windows
# ---------------------------------------------------------------------------


def _bits(a):
    return a.contiguous().view(torch.int16 if a.dtype == torch.bfloat16
                               else torch.int32)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("N,d", [(10, 5000), (64, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_axis_windows_are_the_unsharded_launch(n_shards, N, d, dtype):
    """The logical sharded round (one launch over the padded buffer, the
    layout's counter width) and each window's own launch (col0 = s
    shard_width, the mesh's form) bitwise the one launch over the unpadded
    buffer, on both routes; padding columns zero."""
    _need_card()
    from repro_torch.shard import (ShardLayout, dp_mix_round_sharded,
                                   shard_window_round)
    chan = ChannelConfig(n_workers=N, p_dbm=30.0, sigma=0.7, sigma_m=0.4,
                         seed=N).realize()
    plan = X.plan_complete(None, chan, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(d)
    p = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    g = (0.2 * torch.randn((N, d), generator=gen, device="cuda")).to(dtype)
    whole = ops.dp_mix_round_plan(p, g, 9, plan, gamma=0.05, eta=0.4)
    lay = ShardLayout(d, n_shards)
    before = ops.dp_mix_round.launches
    out = dp_mix_round_sharded(lay.pad(p), lay.pad(g), 9, plan, lay,
                               gamma=0.05, eta=0.4)
    torch.cuda.synchronize()
    assert ops.dp_mix_round.launches == before + 1
    assert torch.equal(_bits(lay.unpad(out)), _bits(whole))
    assert bool((out[:, d:] == 0).all())
    pp, gp, sw = lay.pad(p), lay.pad(g), lay.shard_width
    for a in range(0, lay.padded_width, sw):
        win = shard_window_round(pp[:, a:a + sw].contiguous(),
                                 gp[:, a:a + sw].contiguous(), 9, plan, a,
                                 lay, gamma=0.05, eta=0.4)
        assert torch.equal(_bits(win), _bits(out[:, a:a + sw]))


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_row_windows_stitch_to_the_sparse_round(n_shards, dtype, noisy):
    """dp_mix_prep_rows on each row window (global counters from row0),
    their z gathered by hand, dp_mix_gather_rows on each: bitwise the
    whole population's sparse round. Each workspace bitwise its plain
    twin's (the same operations in the same order); each window's output
    within the sparse round's tolerance of its plain twin."""
    _need_card()
    from repro_torch.kernels.dp_mix.dp_mix import (dp_mix_gather_plain,
                                                   dp_mix_prep_plain)
    from repro_torch.net.sparse import SparseW
    N, d, k = 64, 1001, 12
    args, amp, mscale = _sparse_args(N, d, k, dtype, 5)
    p, g, listen = args[0], args[1], args[8]
    sw = SparseW(args[9], args[10], args[11])
    kw = dict(gamma=0.05, eta=0.4, noisy=noisy, col0=256,
              counter_width=8192)
    whole = ops.dp_mix_round_sparse(p, g, 77, sw, amp, 2.0, 0.3,
                                    m_scale=mscale, listen=listen, **kw)
    nb = N // n_shards
    rows = [slice(s * nb, (s + 1) * nb) for s in range(n_shards)]
    preps, gathers = ops.dp_mix_prep_rows.launches, \
        ops.dp_mix_gather_rows.launches
    ws = [ops.dp_mix_prep_rows(p[r], g[r], 77, amp[r], 2.0, gamma=0.05,
                               row0=r.start, n_workers=N, noisy=noisy,
                               col0=256, counter_width=8192) for r in rows]
    z = torch.cat([w[0] for w in ws])
    outs = [ops.dp_mix_gather_rows(p[r], g[r], w, z, 77, sw[r], amp[r], 2.0,
                                   0.3, row0=r.start, m_scale=mscale[r],
                                   listen=listen[r], **kw)
            for r, w in zip(rows, ws)]
    torch.cuda.synchronize()
    assert ops.dp_mix_prep_rows.launches == preps + n_shards
    assert ops.dp_mix_gather_rows.launches == gathers + n_shards
    assert torch.equal(_bits(torch.cat(outs)), _bits(whole))
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device="cuda")
    scal = torch.tensor([2.0, 0.3], device="cuda")
    for r, w, out in zip(rows, ws, outs):
        twin = dp_mix_prep_plain(p[r], g[r], i32(77), i32(256), scal, amp[r],
                                 gamma=0.05, noisy=noisy,
                                 counter_width=8192, row0=r.start)
        assert torch.equal(w[0], twin[0])
        if noisy:
            assert torch.equal(w[1], twin[1])
        ref = dp_mix_gather_plain(
            p[r], g[r], twin, z, i32(77), i32(256), scal, amp[r],
            torch.ones(nb, device="cuda"), mscale[r], listen[r], sw.idx[r],
            sw.w[r], sw.self_w[r], gamma=0.05, eta=0.4, noisy=noisy,
            counter_width=8192, row0=r.start)
        k32, r32 = out.float(), ref.float()
        x = p[r].float() - 0.05 * g[r].float()
        scale = float(x.abs().max())
        if noisy:
            scale += 5.42 * float((amp / 2.0).abs().max()
                                  + (mscale * 0.3).abs().max())
        allowed = (k + 1 + 8) * 2.0 ** -23 * scale
        if dtype == torch.bfloat16:
            allowed = allowed + 2.0 ** -7 * torch.maximum(k32.abs(), r32.abs())
        assert bool(((k32 - r32).abs() <= allowed).all())


def test_sparse_row0_zero_is_the_round_without_it():
    """row0 = 0 is the sparse round as it was launched without the
    argument (bitwise), and a row0 shifts the noise to the global rows:
    the round on rows [40, 64) with row0 = 40 draws the workspace the
    whole round draws for those rows."""
    _need_card()
    from repro_torch.net.sparse import SparseW
    N, d = 64, 3001
    args, amp, mscale = _sparse_args(N, d, 12, torch.float32, 9)
    kw = dict(gamma=0.05, eta=0.4, noisy=True, counter_width=8192)
    plain = ops._launch_sparse(*args, **kw)
    zero = ops._launch_sparse(*args, row0=0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(plain), _bits(zero))
    p, g = args[0], args[1]
    ws_all = ops.dp_mix_prep_rows(p, g, 77, amp, 2.0, gamma=0.05, row0=0,
                                  n_workers=N, col0=256, counter_width=8192)
    ws_40 = ops.dp_mix_prep_rows(p[40:], g[40:], 77, amp[40:], 2.0,
                                 gamma=0.05, row0=40, n_workers=N, col0=256,
                                 counter_width=8192)
    torch.cuda.synchronize()
    assert torch.equal(ws_40, ws_all[:, 40:])
    sw = SparseW(args[9], args[10], args[11])
    with pytest.raises(ValueError, match="2\\^31"):
        ops.dp_mix_round_sparse(p, g, 77, sw, amp, 2.0, 0.3, gamma=0.05,
                                eta=0.4, row0=(1 << 31) // 8192,
                                counter_width=8192)


@pytest.mark.parametrize("n", [40, 1001, 855050])
def test_row_sum_squares_does_not_depend_on_the_row_count(n):
    """privacy.row_sum_squares (the clip's per-worker norm) gives each row
    the same bits in a block of 1, 2, 5, 10, 16 or 33 rows as in all 64:
    a worker's norm on a mesh rank's row block is the logical mode's; and
    within float32's rounding of the float64 sum."""
    _need_card()
    from repro_torch.core import privacy
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn((64, n), generator=gen, device="cuda")
    whole = privacy.row_sum_squares(x)
    for R in (1, 2, 5, 10, 16, 33):
        for a in (0, 64 - R):
            part = privacy.row_sum_squares(x[a:a + R].contiguous())
            assert torch.equal(_bits(part), _bits(whole[a:a + R])), (R, a)
    ref = torch.sum(x.double() ** 2, dim=1)
    torch.testing.assert_close(whole.double(), ref, rtol=n * 2 ** -24,
                               atol=0)


def _lm_round(flat: bool, dev: str, wp, batch, normals, cfg, proto):
    """One reduced LM round on ``dev``: the flat round at seed 77 or the
    worker-tree round with the given normals."""
    from repro_torch.core import protocol as P
    to = lambda tree: X.tree_map(lambda t: t.to(dev), tree)
    if flat:
        spec = X.FlatSpec(wp)
        step = P.make_flat_train_step(cfg, proto, spec, dev)
        out, m = step(spec.flatten(wp).to(dev), to(batch),
                      torch.tensor([77], dtype=torch.int32, device=dev))
        return out.cpu(), m
    step = P.make_train_step(cfg, proto, dev)
    out, m = step(to(wp), to(batch), None, normals=to(normals))
    return X.flatten_worker_tree(X.tree_map(lambda t: t.cpu(), out)), m


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
def test_reduced_lm_round_on_the_card_matches_cpu(flat):
    """One reduced olmo-1b round (N = 3) on the card against the CPU's
    from the same parameters, token batch and seed (flat: one dp_mix
    launch) or normals (tree, use_pallas: one sgd_update_leaves launch),
    within 1e-4 (1 + max|out|) as the earlier slices' small rounds."""
    _need_card()
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import protocol as P
    from repro_torch.data import LMStore, lm_dataset
    cfg, N = get_arch("olmo-1b").reduced(), 3
    proto = P.ProtocolConfig(n_workers=N, gamma=0.01, eta=0.4,
                             target_epsilon=1.0, use_pallas=not flat)
    gen = torch.Generator().manual_seed(7)
    wp = P.init_worker_params(gen, cfg, N, "cpu")
    store = LMStore.build(lm_dataset(N * 2000, cfg.vocab_size, seed=7), N, 2,
                          32, "cpu")
    batch = store.draw(gen)
    normals = None if flat else X.draw_normals(wp, gen)
    want, wm = _lm_round(flat, "cpu", wp, batch, normals, cfg, proto)
    counter = ops.dp_mix_round if flat else dp_ops.sgd_update_leaves
    before = counter.launches
    got, gm = _lm_round(flat, "cuda", wp, batch, normals, cfg, proto)
    assert counter.launches == before + 1
    tol = 1e-4 * (1.0 + float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-5)


def test_flat_cli_refuses_olmo_full_depth_at_two_workers():
    """C2: olmo-1b's full-depth buffer at N = 2 needs 2 * 1,176,764,416
    noise counters, past 2^31; the flat CLI exits naming C2 before a
    round, and no dp_mix launch is made."""
    _need_card()
    from repro_torch.launch import train
    before = ops.dp_mix_round.launches
    with pytest.raises(SystemExit, match="2 \\* 1176764416 exceeds 2\\^31.*C2"):
        train.run(["--arch", "olmo-1b", "--workers", "2", "--flat-buffer",
                   "--batch-size", "4", "--steps", "0"])
    assert ops.dp_mix_round.launches == before
    torch.cuda.empty_cache()
