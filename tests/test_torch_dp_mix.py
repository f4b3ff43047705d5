"""The port's fused DWFL round on the CPU (repro_torch.kernels.dp_mix:
``dp_mix_plain`` and ``ops.dp_mix_round(device="cpu")``) against the
reference: its fused-jnp lowering and its interpret-mode Pallas kernel at
the same seed, the Eqt. (8) matrix-form oracle, the per-receiver noise
variance, the bf16 contract, gossip, the counter-wrap guard (the only
limit on N), and the C entry's ctypes signature.

Tolerance against the reference's noisy round: both draw the same normals
(within 2 ULP) and sum 3N products in float32 in different orders, so
|port - ref| <= 3N * 2^-24 * scale with scale the largest term; the tests
use atol = 1e-5 * scale at N <= 6."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dwfl
from repro.core import exchange as RX
from repro.core.channel import ChannelConfig as RefChannelConfig
from repro.kernels.dp_mix import ops as ref_ops
from repro_torch.core import exchange as X
from repro_torch.core.channel import ChannelConfig
from repro_torch.kernels.dp_mix import ops
from repro_torch.kernels.dp_mix.dp_mix import dp_mix_plain

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(N=6, d=2000, seed=3, sigma=0.7, sigma_m=0.4):
    kw = dict(n_workers=N, p_dbm=30.0, sigma=sigma, sigma_m=sigma_m,
              seed=seed)
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(N, d)).astype(np.float32)
    g = (0.2 * rng.normal(size=(N, d))).astype(np.float32)
    return (RefChannelConfig(**kw).realize(), ChannelConfig(**kw).realize(),
            p, g)


def _port_plan(chan):
    return X.plan_complete(None, chan, "cpu")


def _scale(out, plan):
    return float(np.abs(out).max()
                 + 5.42 * (plan.amp / plan.c).abs().max().item() + 1.0)


def _doubly_stochastic(N, seed, terms=4):
    rng = np.random.default_rng(seed)
    lam = rng.dirichlet(np.ones(terms))
    W = np.zeros((N, N))
    for t in range(terms):
        W += lam[t] * np.eye(N)[rng.permutation(N)]
    return 0.5 * (W + W.T)


@pytest.mark.parametrize("N,d,seed", [(6, 2000, 7), (3, 4, 0), (8, 1000, -9)])
def test_round_matches_fused_jnp(N, d, seed):
    rchan, chan, p, g = _setup(N, d)
    rplan = RX.plan_complete(None, rchan)
    want = np.asarray(ref_ops.dp_mix_round_plan(
        jnp.asarray(p), jnp.asarray(g), seed, rplan, gamma=0.05, eta=0.4,
        impl="jnp"))
    plan = _port_plan(chan)
    got = ops.dp_mix_round_plan(torch.from_numpy(p), torch.from_numpy(g),
                                seed, plan, gamma=0.05, eta=0.4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * _scale(want, plan))


@pytest.mark.parametrize("N,d,seed", [(65, 300, 5), (128, 130, -2)])
def test_plain_matches_fused_jnp_at_large_n(N, d, seed):
    """The rows the card's large-N route serves (N > the column route's).
    Both sum 3N products in float32 in different orders: atol = 3N 2^-24
    scale."""
    rchan, chan, p, g = _setup(N, d, seed=seed % 17)
    rplan = RX.plan_complete(None, rchan)
    want = np.asarray(ref_ops.dp_mix_round_plan(
        jnp.asarray(p), jnp.asarray(g), seed, rplan, gamma=0.05, eta=0.4,
        impl="jnp"))
    plan = _port_plan(chan)
    got = ops.dp_mix_round_plan(torch.from_numpy(p), torch.from_numpy(g),
                                seed, plan, gamma=0.05, eta=0.4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=3 * N * 2.0 ** -24 * _scale(want, plan))


def test_plain_matches_interpret_pallas_kernel():
    N, d, seed = 6, 500, 7
    rchan, chan, p, g = _setup(N, d)
    rplan = RX.plan_complete(None, rchan)
    want = np.asarray(ref_ops.dp_mix_round_plan(
        jnp.asarray(p), jnp.asarray(g), seed, rplan, gamma=0.05, eta=0.4,
        impl="pallas_interpret"))
    plan = _port_plan(chan)
    cw = ops._roundup(d, ops.LANES)
    got = dp_mix_plain(
        torch.from_numpy(p), torch.from_numpy(g),
        torch.tensor([seed], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32),
        torch.stack([plan.c, plan.sigma_m]), plan.amp, torch.ones(N),
        plan.m_scale, torch.ones(N), plan.W, gamma=0.05, eta=0.4,
        noisy=True, counter_width=cw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * _scale(want, plan))


def test_col0_window_matches_reference_window():
    """A column window (col0, counter_width) draws the reference's noise
    for those global columns."""
    N, d, seed = 4, 384, 11
    rchan, chan, p, g = _setup(N, d)
    rplan = RX.plan_complete(None, rchan)
    want = np.asarray(ref_ops.dp_mix_round_plan(
        jnp.asarray(p[:, 128:256]), jnp.asarray(g[:, 128:256]), seed, rplan,
        gamma=0.05, eta=0.4, impl="jnp", col0=128, counter_width=384))
    got = ops.dp_mix_round_plan(
        torch.from_numpy(p[:, 128:256].copy()),
        torch.from_numpy(g[:, 128:256].copy()), seed, _port_plan(chan),
        gamma=0.05, eta=0.4, col0=128, counter_width=384)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * _scale(want, _port_plan(chan)))


def test_deterministic_matches_matrix_reference():
    """sigma = sigma_m = 0: the exact Eqt. (8) mixing X <- (X - gamma G) Psi."""
    N, d = 6, 500
    rchan, chan, p, g = _setup(N, d)
    plan = _port_plan(chan)
    gamma, eta = 0.1, 0.45
    out = ops.dp_mix_round(torch.from_numpy(p), torch.from_numpy(g), 7,
                           plan.W, 0.0 * plan.amp, plan.c, 0.0, gamma=gamma,
                           eta=eta, m_scale=plan.m_scale)
    want = dwfl.matrix_form_reference(p, g, np.zeros((N, d)),
                                      np.zeros((N, d)), rchan, gamma, eta)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("N,d,eta,seed", [
    (3, 4, 0.05, 0),                       # recorded Hypothesis examples
    (3, 8, 0.849801839724448, 3654),
    (7, 64, 0.6, 42),
])
def test_noisy_round_matches_matrix_reference(N, d, eta, seed):
    """Any doubly-stochastic W: the port's round equals the Eqt. (8) oracle
    fed the port's own noise fields n = amp * Gn, m = sigma_m * Gm."""
    rchan, chan, p, g = _setup(N, d, seed=seed % 17, sigma=1.5, sigma_m=0.3)
    W = _doubly_stochastic(N, seed)
    Wt = torch.tensor(W, dtype=torch.float32)
    amp = X.mix_noise_amp(chan, "cpu")
    deg = torch.clamp_min((Wt > 0).sum(1).float(), 1.0)
    gamma = 0.07
    out = ops.dp_mix_round(torch.from_numpy(p), torch.from_numpy(g), seed, Wt,
                           amp, chan.c, chan.awgn_sigma, gamma=gamma, eta=eta,
                           m_scale=1.0 / (chan.c * deg))
    from repro_torch.kernels import noise
    g_n, g_m = noise.normal_pair_hash((N, d), ops._roundup(d, 128), 0, seed)
    want = dwfl.matrix_form_reference(
        p, g, (amp[:, None] * g_n).numpy(),
        (chan.awgn_sigma * g_m).numpy(), rchan, gamma, eta, W=W)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-5)
    # Eqt. (9) with sigma_m = 0: the DP noises cancel in the worker mean
    out0 = ops.dp_mix_round(torch.from_numpy(p), torch.from_numpy(g), seed,
                            Wt, amp, chan.c, 0.0, gamma=gamma, eta=eta,
                            m_scale=1.0 / (chan.c * deg))
    np.testing.assert_allclose(out0.numpy().mean(0),
                               (p - gamma * g).mean(0), rtol=2e-4, atol=2e-5)


def test_per_receiver_noise_variance():
    """Var_i = eta^2 [sum_{k != i} W_ik^2 amp_k^2 + amp_i^2] / c^2
    + eta^2 m_scale_i^2 sigma_m^2 on the complete graph."""
    N, d = 6, 30_000
    rchan, chan, p, g = _setup(N, d)
    plan = _port_plan(chan)
    gamma, eta = 0.1, 0.45
    pt, gt = torch.from_numpy(p), torch.from_numpy(g)
    det = ops.dp_mix_round(pt, gt, 7, plan.W, 0.0 * plan.amp, plan.c, 0.0,
                           gamma=gamma, eta=eta, m_scale=plan.m_scale)
    out = ops.dp_mix_round(pt, gt, 7, plan.W, plan.amp, plan.c,
                           chan.awgn_sigma, gamma=gamma, eta=eta,
                           m_scale=plan.m_scale)
    amp = plan.amp.double().numpy()
    Wm = plan.W.double().numpy()
    c = float(chan.c)
    ms = plan.m_scale.double().numpy()
    var = np.array([
        eta ** 2 * ((Wm[i] ** 2 * amp ** 2).sum() + amp[i] ** 2) / c ** 2
        + eta ** 2 * ms[i] ** 2 * chan.cfg.sigma_m ** 2 for i in range(N)])
    resid = out.double().numpy() - det.double().numpy()
    np.testing.assert_allclose(resid.std(axis=1) / np.sqrt(var), 1.0,
                               atol=0.04)
    assert np.abs(resid.mean(axis=1)).max() < 5 * np.sqrt(var.max() / d)


def test_seed_sensitivity_and_bf16_contract():
    rchan, chan, p, g = _setup()
    plan = _port_plan(chan)
    pt, gt = torch.from_numpy(p), torch.from_numpy(g)
    a = ops.dp_mix_round_plan(pt, gt, 7, plan, gamma=0.05, eta=0.4)
    b = ops.dp_mix_round_plan(pt, gt, 8, plan, gamma=0.05, eta=0.4)
    assert float((a - b).abs().max()) > 1e-3
    ob = ops.dp_mix_round_plan(pt.bfloat16(), gt.bfloat16(), 7, plan,
                               gamma=0.05, eta=0.4)
    assert ob.dtype == torch.bfloat16
    np.testing.assert_allclose(ob.float().numpy(), a.numpy(), atol=0.15)
    # the reference's bf16 round, same inputs and seed
    rb = ref_ops.dp_mix_round_plan(jnp.asarray(p, jnp.bfloat16),
                                   jnp.asarray(g, jnp.bfloat16), 7,
                                   RX.plan_complete(None, rchan), gamma=0.05,
                                   eta=0.4, impl="jnp")
    np.testing.assert_allclose(ob.float().numpy(),
                               np.asarray(rb, np.float32), rtol=2 ** -7,
                               atol=1e-5 * _scale(a.numpy(), plan))


def test_gossip_noiseless_path():
    """noisy=False: pure mixing, the worker mean exactly preserved."""
    rchan, chan, p, g = _setup()
    gplan = X.plan_gossip(None, chan, "cpu")
    out = ops.dp_mix_round_plan(torch.from_numpy(p), torch.from_numpy(g), 7,
                                gplan, gamma=0.05, eta=0.5)
    x = torch.from_numpy(p - 0.05 * g)
    np.testing.assert_allclose(out.numpy().mean(0), x.numpy().mean(0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), (x + 0.5 * (gplan.W @ x - x)).numpy(),
                               rtol=1e-5, atol=1e-6)
    want = ref_ops.dp_mix_round_plan(jnp.asarray(p), jnp.asarray(g), 7,
                                     RX.plan_gossip(None, rchan), gamma=0.05,
                                     eta=0.5, impl="jnp")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_counter_wrap_guard_and_cpu_path_counts_nothing():
    p = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="2\\^31"):
        ops.dp_mix_round(p, p, 0, torch.eye(3), torch.ones(3), 1.0, 0.0,
                         gamma=0.1, eta=0.5, counter_width=1 << 30)
    # the dwfl-paper buffer at full width hits the guard from N = 2,512
    cw = ops._roundup(855_050, ops.LANES)
    assert 2511 * cw <= ops.COUNTER_LIMIT < 2512 * cw
    before = ops.dp_mix_round.launches
    ops.dp_mix_round(p, p, 0, torch.eye(3), torch.ones(3), 1.0, 0.0,
                     gamma=0.1, eta=0.5)
    assert ops.dp_mix_round.launches == before


def test_wrapper_takes_any_n_below_the_counter_limit():
    """No limit on N but C2's: N = 65 and 130 run, and N * counter_width
    past 2^31 still raises at N = 65."""
    for N in (65, 130):
        p = torch.zeros((N, 8))
        out = ops.dp_mix_round(p, p, 0, torch.eye(N), torch.ones(N), 1.0, 0.0,
                               gamma=0.1, eta=0.5)
        assert out.shape == (N, 8)
    p = torch.zeros((65, 8))
    with pytest.raises(ValueError, match="2\\^31"):
        ops.dp_mix_round(p, p, 0, torch.eye(65), torch.ones(65), 1.0, 0.0,
                         gamma=0.1, eta=0.5, counter_width=(1 << 31) // 64)


def test_argtypes_follow_the_c_entry():
    """One ARGTYPES entry per parameter of dp_mix_launch, of the C
    parameter's kind: a missing or extra entry shifts every argument after
    it, and ctypes cuts a pointer passed as an int to 32 bits."""
    import ctypes
    import re
    text = (ops._CSRC / "dp_mix.cu").read_text()
    sig = re.search(r"int dp_mix_launch\(([^)]*)\)\s*\{", text).group(1)
    params = [" ".join(a.split()[:-1]) for a in sig.split(",")]
    assert len(params) == len(ops.ARGTYPES)
    for c_type, py in zip(params, ops.ARGTYPES):
        want = (ctypes.c_void_p if "*" in c_type else
                ctypes.c_float if c_type == "float" else
                ctypes.c_uint if "unsigned" in c_type else ctypes.c_int)
        assert py is want, (c_type, py)


def test_seed_from_key_matches_reference():
    for s in (0, 5, 2**20 + 3):
        key = jax.random.fold_in(jax.random.PRNGKey(s), 1)
        want = int(ref_ops.seed_from_key(key))
        assert int(ops.seed_from_key(np.asarray(key))) == want


def test_chip_smoke_counts_each_normal_on_its_branches():
    """chip_smoke.noise_branches: every normal of a round once, on log1p's
    small or large branch by its t, and in the erfinv tail where w >= 5,
    as the plain generator's own arithmetic has them."""
    from repro_torch.kernels import noise
    N, d, cw, seed = 3, 5000, 5120, 77
    got = chip_smoke.noise_branches(N, d, cw, seed, device="cpu")
    idx2 = (noise.counters((N, d), cw) * 2) & noise.MASK32
    small = tail = 0
    for f in (0, 1):
        bits = noise.hash_bits(idx2 + f, seed)
        t = (((bits >> 8).to(torch.float32) - (float(1 << 23) - 0.5))
             * (1.0 / (1 << 23)))
        x = t * -t
        small += int((x.abs() < noise._L1P_SMALL).sum())
        tail += int((-noise.log1p_xla(x) >= 5.0).sum())
    assert got == {"small": small, "large": 2 * N * d - small, "tail": tail}
    assert got["tail"] > 0


def test_chip_smoke_dp_mix_bound_at_the_path_shape():
    """The three terms of B1's bound at (10, 855,050, float32): 102.6 MB
    over 3.35 TB/s, the instructions over 132 SMs x 128 lanes at 1.98 GHz,
    and 10^2 d FMAs at 67 TFLOP/s; the longest bounds it. An element's
    instructions besides its normals are its arithmetic alone (20 noisy,
    14 gossip at N = 10): its loads and store are in the byte term."""
    N, d = 10, 855_050
    assert chip_smoke.dp_mix_element_ops(N, True) == 20
    assert chip_smoke.dp_mix_element_ops(N, False) == 14
    counts = {"small": 52, "large": 58, "tail_extra": 14}
    rates = {"sms": 132, "sm_clock_hz": 1.98e9}
    branches = {"small": 11_000_000, "large": 6_101_000, "tail": 58_000}
    w = chip_smoke.dp_mix_work(N, d, 4, True, counts, rates, branches)
    assert w["bytes"] == 3 * N * d * 4 + (N * N + 4 * N + 4) * 4 == 102_606_576
    instr = (11_000_000 * 52 + 6_101_000 * 58 + 58_000 * 14
             + N * d * chip_smoke.dp_mix_element_ops(N, True))
    assert w["lane_instructions"] == instr
    assert w["instructions_ms"] == pytest.approx(1e3 * instr / (132 * 128 * 1.98e9))
    assert w["fma_ms"] == pytest.approx(1e3 * 2 * N * N * d / 67e12)
    assert w["bound_ms"] == max(w["bytes_ms"], w["instructions_ms"], w["fma_ms"])
    assert w["bound_by"] == "operations"
    gossip = chip_smoke.dp_mix_work(N, d, 4, False, counts, rates)
    assert gossip["bound_by"] == "bytes"
    assert gossip["lane_instructions"] == N * d * chip_smoke.dp_mix_element_ops(N, False)


def test_chip_smoke_dp_mix_bound_on_the_large_n_route():
    """At (2048, 855,050, float32) the mix runs on the tensor cores: the
    bound's terms are the bytes, the instructions without the mix's N FMAs
    an element, and 2 N^2 d operations at 495 TFLOP/s (it bounds); beside
    it the route's split products (three TF32 products a product), its
    floor with the prep's workspace traffic, and the CUDA-core bound
    (the N FMAs as instructions, the FMAs at 67 TFLOP/s)."""
    N, d = 2048, 855_050
    counts = {"small": 52, "large": 58, "tail_extra": 14}
    rates = {"sms": 132, "sm_clock_hz": 1.98e9}
    branches = {"small": 2_200_000_000, "large": 1_302_000_000,
                "tail": 12_000_000}
    lanes = 132 * 128 * 1.98e9
    normals = 2_200_000_000 * 52 + 1_302_000_000 * 58 + 12_000_000 * 14
    w = chip_smoke.dp_mix_work(N, d, 4, True, counts, rates, branches)
    assert w["compute_class"] == "tf32"
    assert w["lane_instructions"] == normals + N * d * (
        chip_smoke.dp_mix_element_ops(N, True) - N)
    assert w["tensor_ms"] == pytest.approx(1e3 * 2 * N * N * d / 495e12)
    assert w["split_ms"] == pytest.approx(3 * w["tensor_ms"])
    assert w["route_floor_ms"] == pytest.approx(
        w["split_ms"] + 1e3 * 16 * N * d / 3.35e12)
    assert w["bound_ms"] == w["tensor_ms"] == max(w["terms_ms"].values())
    assert w["bound_by"] == "operations"
    cc = w["cuda_core_terms_ms"]
    assert cc["instructions"] == pytest.approx(
        1e3 * (normals + N * d * chip_smoke.dp_mix_element_ops(N, True))
        / lanes)
    assert cc["fma"] == pytest.approx(1e3 * 2 * N * N * d / 67e12)
    assert w["cuda_core_bound_ms"] == max(cc.values()) > 100


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_chip_smoke_dp_mix_exact_is_the_plain_round(noisy):
    """chip_smoke.dp_mix_exact, the card's split-precision yardstick, is
    dp_mix_plain's round in float64: the plain float32 round lies within
    sqrt(N) 2^-23 scale of it (dp_mix_split_tolerance) on the CPU, at an N
    past the column route with per-receiver vectors, and its gossip round
    is W x (listen 1, eta 1)."""
    N, d = 70, 300
    rng = np.random.default_rng(5)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    p, g = f32(rng.standard_normal((N, d))), f32(rng.standard_normal((N, d)))
    W = f32(rng.random((N, N)))
    W = W / W.sum(1, keepdim=True)
    vec = lambda lo: f32(rng.uniform(lo, 1.0, N))
    plan = SimpleNamespace(amp=vec(0.1), c=torch.tensor(1.3),
                           m_scale=vec(0.2), sigma_m=torch.tensor(0.4))
    args = (p, g, torch.tensor([9], dtype=torch.int32),
            torch.tensor([64], dtype=torch.int32),
            torch.stack([plan.c, plan.sigma_m]), plan.amp, vec(0.0),
            plan.m_scale, vec(0.5), W)
    kw = dict(gamma=0.05, eta=0.4 if noisy else 1.0, noisy=noisy,
              counter_width=512)
    exact = chip_smoke.dp_mix_exact(*args, **kw)
    assert exact.dtype == torch.float64 and exact.shape == (N, d)
    tol = chip_smoke.dp_mix_split_tolerance(
        N, chip_smoke.dp_mix_scale(p, g, 0.05, plan, noisy))
    err = float((dp_mix_plain(*args, **kw).double() - exact).abs().max())
    assert 0 < err <= tol
    if not noisy:
        x = (p - 0.05 * g).double()
        lst = args[8].double()[:, None]
        assert torch.allclose(exact, x + lst * (W.double() @ x - x),
                              rtol=0, atol=1e-12)


def test_chip_smoke_last_line_names_are_bound_once():
    """chip_smoke.main binds the last line's ``kind`` and ``count`` (the
    card's name and count) once: no later loop or assignment in main may
    take those names over before the line prints them."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(chip_smoke.main))
    bound = [n.id for n in ast.walk(tree)
             if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)]
    assert bound.count("kind") == bound.count("count") == 1


def test_chip_smoke_reads_instructions_up_to_exit():
    """chip_smoke.sass_until_exit counts each function's SASS instruction
    lines up to its first EXIT, not the encodings or what follows."""
    sass = """
\tcode for sm_90a
\t\tFunction : k_a
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000f00 */
        /*0010*/                   FFMA R2, R1, R1, R1 ;      /* 0x0000000101027223 */
        /*0020*/                   EXIT ;                     /* 0x000000000000794d */
        /*0030*/                   BRA 0x30;                  /* 0xfffffffc00fc7947 */
\t\tFunction : k_b
        /*0000*/                   EXIT ;                     /* 0x000000000000794d */
"""
    class Lib:
        pass
    orig = chip_smoke.sass_text
    chip_smoke.sass_text = lambda lib: sass
    try:
        assert chip_smoke.sass_until_exit(Lib()) == {"k_a": 3, "k_b": 1}
    finally:
        chip_smoke.sass_text = orig
