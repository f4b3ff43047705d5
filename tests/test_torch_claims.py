"""The paper's claims on the port (pytest -m claims): the tests of
tests/test_claims.py that this slice of repro_torch can run — Theorem 4.1
/ Remark 4.1's per-worker epsilon = O(1/sqrt(N - 1)) across an N grid, the
Remark 4.1 bound, the orthogonal budget that does not amplify with N, the
calibrated sigma that shrinks with N, and Fig. 5's accuracy claim (DWFL >=
orthogonal at matched per-worker epsilon) trained by the port's own
worker-tree step on the CPU, at the reference test's sizes and seeds
(N = 8, d_model 64, 300 rounds, data and channel seeds 0 and 1), with the
port's own generator draws; advanced composition sublinear in T at a small
per-round epsilon, and the Renyi ledger never looser than delta-split
advanced composition, over the static grid and a realized dynamic
trajectory (the reference's ``sim.trajectory(PRNGKey(0), 64)``, its
channels and Ws replayed: jax.random draws are not re-derived). Bounds
and tolerances are the reference test's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import privacy
from repro_torch.core import protocol as P
from repro_torch.data import (FederatedBatcher, classification_dataset,
                              dirichlet_partition)
from repro_torch.models import mlp

pytestmark = pytest.mark.claims

N_GRID = (4, 8, 16, 32)
SEEDS = range(8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _proto(N, seed, *, fading="rayleigh", target_epsilon=0.0, sigma_m=1.0):
    return P.ProtocolConfig(scheme="dwfl", n_workers=N, gamma=0.02,
                            clip=1.0, sigma=1.0, sigma_m=sigma_m,
                            p_dbm=60.0, fading=fading, seed=seed,
                            target_epsilon=target_epsilon)


def _grid_mean(fn):
    """Mean of ``fn(proto, chan)`` over the seed grid, per N."""
    out = []
    for N in N_GRID:
        vals = []
        for seed in SEEDS:
            proto = _proto(N, seed)
            vals.append(fn(proto, proto.channel()))
        out.append(float(np.mean(vals)))
    return np.asarray(out)


def _loglog_slope(ns, ys):
    return float(np.polyfit(np.log(np.asarray(ns, float)),
                            np.log(np.asarray(ys, float)), 1)[0])


def test_epsilon_per_worker_follows_inverse_sqrt_n_law():
    """Unit fading: the per-worker epsilon of epsilon_report scales as
    1/sqrt(N - 1), exactly: eps(N)/eps(4) == sqrt(3/(N - 1))."""
    eps = []
    for N in N_GRID:
        proto = _proto(N, 0, fading="unit", sigma_m=0.0)
        rep = P.epsilon_report(proto, proto.channel())
        eps.append(float(np.mean(rep["epsilon_per_worker"])))
    slope = _loglog_slope(N_GRID, eps)
    assert -0.65 < slope < -0.40, (slope, eps)
    ratio = np.asarray(eps) / eps[0]
    want = np.sqrt(3.0 / (np.asarray(N_GRID) - 1.0))
    np.testing.assert_allclose(ratio, want, rtol=1e-5)


def test_epsilon_per_worker_decreases_at_least_sqrt_n_under_fading():
    eps = _grid_mean(lambda proto, chan: np.mean(
        P.epsilon_report(proto, chan)["epsilon_per_worker"]))
    assert (np.diff(eps) < 0).all(), eps
    slope = _loglog_slope(N_GRID, eps)
    assert slope < -0.4, (slope, eps)


def test_remark41_bound_dominates_exact_budget():
    for N in N_GRID:
        for seed in SEEDS:
            proto = _proto(N, seed)
            chan = proto.channel()
            exact = privacy.epsilon_dwfl(proto.gamma, proto.clip, chan,
                                         proto.delta)
            bound = privacy.epsilon_dwfl_bound(proto.gamma, proto.clip,
                                               chan, proto.delta)
            assert (exact <= bound * (1 + 1e-9)).all(), (N, seed)


def test_orthogonal_budget_does_not_amplify_with_n():
    dwfl = _grid_mean(lambda proto, chan: np.mean(
        privacy.epsilon_dwfl(proto.gamma, proto.clip, chan, proto.delta)))
    orth = _grid_mean(lambda proto, chan: np.mean(
        privacy.epsilon_orthogonal(proto.gamma, proto.clip, chan,
                                   proto.delta)))
    dwfl_decay = dwfl[0] / dwfl[-1]
    orth_decay = orth[0] / orth[-1]
    assert orth_decay < 3.0, orth
    assert dwfl_decay > 3.0 * orth_decay, (dwfl_decay, orth_decay)


def test_calibrated_sigma_shrinks_with_n():
    sig = []
    for N in N_GRID:
        vals = []
        for seed in SEEDS:
            proto = _proto(N, seed, target_epsilon=0.5, sigma_m=0.1)
            vals.append(proto.channel().cfg.sigma)
        sig.append(float(np.mean(vals)))
    assert (np.diff(sig) < 0).all(), sig
    assert _loglog_slope(N_GRID, sig) < -0.4, sig


def test_composition_sublinear_in_small_epsilon_regime():
    """Advanced composition beats naive T eps at a small per-round eps, and
    the heterogeneous composer is the homogeneous one on a constant
    trajectory."""
    e_round, delta, T = 0.05, 1e-5, 200
    e_adv, d_adv = privacy.compose_advanced(e_round, delta, T)
    e_naive, _ = privacy.compose_naive(e_round, delta, T)
    assert e_adv < e_naive, (e_adv, e_naive)
    e_het, d_het = privacy.compose_heterogeneous(np.full(T, e_round), delta)
    assert e_het == pytest.approx(e_adv, rel=1e-9)
    assert d_het == pytest.approx(d_adv, rel=1e-9)


def test_rdp_never_looser_than_advanced_composition():
    """The Renyi ledger quotes at most the delta-split advanced composition
    at the same total delta, over the N x scheme/topology x fading static
    grid and a realized dynamic iot_dense trajectory of 64 rounds."""
    T = 256
    for N in N_GRID:
        for scheme, topology in (("dwfl", "complete"), ("dwfl", "ring"),
                                 ("orthogonal", "complete")):
            for fading in ("rayleigh", "unit"):
                for seed in (0, 3):
                    proto = P.ProtocolConfig(
                        scheme=scheme, n_workers=N, gamma=0.02, clip=1.0,
                        sigma=1.0, sigma_m=1.0, p_dbm=60.0, fading=fading,
                        seed=seed, topology=topology, target_epsilon=0.0)
                    rep = P.epsilon_report(proto, proto.channel(), T=T)
                    ctx = (N, scheme, topology, fading, seed)
                    assert (rep["epsilon_T_rdp"]
                            <= rep["epsilon_T_advanced_split"]), ctx
                    assert rep["delta_T_total"] == proto.delta, ctx
    import jax
    from repro.core import protocol as RP
    from test_torch_net import port_chan, t
    kw = dict(scheme="dwfl", n_workers=8, gamma=0.02, clip=1.0, sigma=1.0,
              sigma_m=1.0, channel_model="dynamic", scenario="iot_dense",
              target_epsilon=0.0)
    chans, _, Ws = RP.ProtocolConfig(**kw).simulator().trajectory(
        jax.random.PRNGKey(0), 64)
    proto = P.ProtocolConfig(**kw)
    rep = P.epsilon_report(proto, port_chan(chans), Ws=t(Ws))
    assert rep["rounds"] == 64
    assert rep["epsilon_rdp"] <= rep["epsilon_advanced"]
    assert rep["epsilon_total"] == pytest.approx(
        min(rep["epsilon_rdp"], rep["epsilon_advanced"]))
    assert rep["delta_total"] == proto.delta
    assert rep["accountant_gap"] > 1.15


def _train_accuracy(scheme, *, steps, N=8, epsilon=1.0, seed=0):
    input_dim = 256
    cfg = dataclasses.replace(DWFL_PAPER, d_model=64)
    x, y = classification_dataset(6000, input_dim=input_dim, seed=seed)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=seed)
    bat = FederatedBatcher(x, y, parts, batch_size=32, seed=seed)
    proto = P.ProtocolConfig(scheme=scheme, n_workers=N, gamma=0.02,
                             eta=0.4, clip=1.0, target_epsilon=epsilon,
                             seed=seed, p_dbm=70.0)
    gen = torch.Generator().manual_seed(seed)
    params = mlp.init(gen, cfg, input_dim=input_dim, device="cpu")
    wp = X.tree_map(lambda a: a.expand((N,) + a.shape).contiguous(), params)
    step = P.make_train_step(cfg, proto, "cpu")
    as_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    for _ in range(steps):
        wp, _ = step(wp, as_t(bat.next()), gen)
    ev_loss, ev_acc = P.make_eval_fn(cfg)(wp, as_t(bat.full(128)))
    return float(ev_loss), float(ev_acc)


def test_dwfl_accuracy_matches_orthogonal_at_matched_epsilon():
    """Fig. 5: both schemes calibrated to the same per-worker per-round
    epsilon (scheme-aware sigma), DWFL's test accuracy is at least the
    orthogonal scheme's over two seeds, up to 2 points; its loss is no
    worse either (up to 0.05)."""
    accs_d, accs_o, losses_d, losses_o = [], [], [], []
    for seed in (0, 1):
        ld, ad = _train_accuracy("dwfl", steps=300, epsilon=1.0, seed=seed)
        lo, ao = _train_accuracy("orthogonal", steps=300, epsilon=1.0,
                                 seed=seed)
        accs_d.append(ad), accs_o.append(ao)
        losses_d.append(ld), losses_o.append(lo)
    assert np.mean(accs_d) >= np.mean(accs_o) - 0.02, (accs_d, accs_o)
    assert np.mean(losses_d) <= np.mean(losses_o) + 0.05, (losses_d,
                                                           losses_o)
