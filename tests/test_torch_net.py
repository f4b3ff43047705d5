"""The port's dynamic wireless network (``repro_torch.net``) against the
reference's ``repro.net`` on the CPU.

The deterministic parts take the reference's realized operands, replayed
into the port: ``align``, ``magnitudes`` and ``channel_state`` from a
realized fading state and path gain, ``path_gain``, ``adjacency`` (with
its mask and fallback) and ``metropolis_weights`` from realized
positions, the masked complete graph, and the simulator's calibrated
channel (all three targets) from a realized network state. Both packages
compute these in float32, in orders that may differ by a few roundings:
rtol 1e-6 (bitwise where only comparisons are involved: the adjacency).
The scenario presets are the reference's numbers exactly.

The port's own draws (``torch.Generator``; jax.random is not re-derived)
are checked in distribution, as tests/test_net.py checks the reference's:
the AR(1) correlation within 0.03 (3,840 pairs), the block structure,
Rician concentration (mean within 0.02 of 1, std < 0.15 over 2,048),
the churn chain's stationary rate within 0.03 (4,096 workers, 30 rounds)
and its minimum of active workers, waypoint bounds and speed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.channel import ChannelConfig as RefChannelConfig
from repro.net import churn as rchurn
from repro.net import fading as rfading
from repro.net import geometry as rgeometry
from repro.net import scenarios as rscenarios
from repro.net import simulator as rsimulator
from repro.net import state as rstate
from repro_torch.core.channel import ChannelConfig
from repro_torch.net import churn, fading, geometry, scenarios, simulator
from repro_torch.net.sparse import SparseW
from repro_torch.net.state import (FIELDS, TracedChannelState, concat_states,
                                   stack_states)

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def t(a):
    """A reference array as a CPU tensor."""
    return torch.from_numpy(np.array(a))


def port_chan(rchan) -> TracedChannelState:
    """The reference's realized TracedChannelState, replayed."""
    return TracedChannelState(**{f: t(getattr(rchan, f)) for f in FIELDS},
                              n_workers=rchan.n_workers)


def port_state(rnet) -> simulator.NetState:
    """The reference's realized NetState, replayed."""
    f, g, c = rnet.fading, rnet.geometry, rnet.churn
    return simulator.NetState(
        fading=fading.FadingState(diffuse=t(f.diffuse), t=t(f.t)),
        geometry=geometry.GeometryState(pos=t(g.pos), waypoint=t(g.waypoint),
                                        speed=t(g.speed)),
        churn=churn.ChurnState(up=t(c.up)))


def ref_round(scenario, n, seed, rounds=3, **kw):
    """A reference simulator and its network state, channel, mask and W
    after ``rounds`` rounds."""
    sim = rsimulator.NetworkSimulator(rscenarios.get_scenario(scenario), n,
                                      **kw)
    st = sim.init(jax.random.PRNGKey(seed))
    k = jax.random.PRNGKey(seed + 1)
    for _ in range(rounds):
        k, kk = jax.random.split(k)
        st, chan, mask, W = sim.round(kk, st)
    return sim, st, chan, mask, W


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the traced channel state
# ---------------------------------------------------------------------------


def test_traced_state_mirrors_static_and_reference():
    kw = dict(n_workers=6, p_dbm=40.0, sigma=0.8, sigma_m=0.5, seed=3)
    chan, rchan = ChannelConfig(**kw).realize(), RefChannelConfig(**kw).realize()
    tr = TracedChannelState.from_static(chan, "cpu")
    rtr = rstate.TracedChannelState.from_static(rchan)
    for name in ("noise_scale", "signal_scale", "aggregate_noise_std"):
        close(getattr(tr, name), getattr(chan, name), rtol=1e-6)
        close(getattr(tr, name), getattr(rtr, name))
    assert float(tr.dp_sigma) == pytest.approx(0.8) and tr.n_workers == 6
    tr2 = tr.with_sigma(torch.tensor(0.25))
    assert float(tr2.sigma) == 0.25 and float(tr.sigma) == pytest.approx(0.8)
    st = stack_states([tr, tr2])
    assert st.h.shape == (2, 6) and st.sigma.shape == (2,)
    close(st.aggregate_noise_std[1], tr2.aggregate_noise_std)
    assert concat_states([st, st]).c.shape == (4,)


# ---------------------------------------------------------------------------
# fading
# ---------------------------------------------------------------------------


def test_bessel_and_doppler_equal_reference():
    x = np.linspace(0.0, 12.0, 97)
    np.testing.assert_array_equal(fading.bessel_j0(x), rfading.bessel_j0(x))
    for f_d, tau in ((0.0, 1.0), (1.0, 0.05), (5.0, 0.05), (10.0, 0.05)):
        assert fading.rho_from_doppler(f_d, tau) == \
            rfading.rho_from_doppler(f_d, tau)


@pytest.mark.parametrize("policy", ["surplus", "equal"])
def test_align_equals_reference_and_static_rule(policy):
    chan = RefChannelConfig(n_workers=8, p_dbm=40.0, seed=5,
                            noise_policy=policy).realize()
    h, P = np.float32(chan.h), np.float32(chan.P)
    ra, rb, rc = rfading.align(jnp.asarray(h), jnp.asarray(P),
                               noise_policy=policy)
    a, b, c = fading.align(torch.from_numpy(h), torch.from_numpy(P),
                           noise_policy=policy)
    close(a, ra)
    close(b, rb)
    close(c, rc)
    close(a, chan.alpha, rtol=1e-5)


@pytest.mark.parametrize("kind", ["rayleigh", "rician", "unit"])
def test_channel_state_from_replayed_fading_equals_reference(kind):
    """magnitudes x sqrt(path gain), re-aligned: the reference's realized
    diffuse gains and positions through both."""
    cfg_kw = dict(kind=kind, rician_k=6.0)
    rcfg, cfg = rfading.FadingConfig(**cfg_kw), fading.FadingConfig(**cfg_kw)
    rst = rfading.init_fading(rcfg, jax.random.PRNGKey(3), 9)
    st = fading.FadingState(diffuse=t(rst.diffuse), t=t(rst.t))
    close(fading.magnitudes(cfg, st), rfading.magnitudes(rcfg, rst))
    gkw = dict(pl_exponent=3.2, ref_distance=10.0)
    pos = np.float32(np.random.default_rng(0).uniform(0, 1000, (9, 2)))
    rgain = rgeometry.path_gain(rgeometry.GeometryConfig(**gkw),
                                jnp.asarray(pos))
    rch = rfading.channel_state(rcfg, rst, 1000.0, 0.7, 0.3,
                                path_gain=rgain)
    ch = fading.channel_state(cfg, st, 1000.0, 0.7, 0.3, path_gain=t(rgain))
    for f in FIELDS:
        close(getattr(ch, f), getattr(rch, f))


def test_fading_ar1_correlation():
    cfg = fading.FadingConfig(kind="rayleigh", rho=0.9, coherence_rounds=1)
    g = gen(0)
    st = fading.init_fading(cfg, g, 64)
    xs = [st.diffuse[:, 0]]
    for _ in range(60):
        st = fading.advance(cfg, g, st)
        xs.append(st.diffuse[:, 0])
    xs = torch.stack(xs).numpy()
    corr = np.corrcoef(xs[:-1].ravel(), xs[1:].ravel())[0, 1]
    assert corr == pytest.approx(0.9, abs=0.03), corr
    # the stationary per-component variance stays diffuse_std^2 = 1/2
    assert xs.var() == pytest.approx(0.5, rel=0.15)


def test_fading_block_structure():
    cfg = fading.FadingConfig(kind="rayleigh", rho=0.3, coherence_rounds=5)
    g = gen(1)
    st = fading.init_fading(cfg, g, 16)
    hs = []
    for _ in range(15):
        st = fading.advance(cfg, g, st)
        hs.append(fading.magnitudes(cfg, st).numpy())
    hs = np.stack(hs)      # redraws at t = 5, 10, 15: rows 4, 9, 14
    assert np.array_equal(hs[0], hs[3]) and np.array_equal(hs[4], hs[8])
    assert not np.allclose(hs[3], hs[4]) and not np.allclose(hs[8], hs[9])
    assert int(st.t) == 15


def test_rician_k_concentrates_gain():
    cfg = fading.FadingConfig(kind="rician", rician_k=50.0)
    h = fading.magnitudes(cfg, fading.init_fading(cfg, gen(2), 2048)).numpy()
    assert abs(h.mean() - 1.0) < 0.02 and h.std() < 0.15
    cfg_r = fading.FadingConfig(kind="rayleigh")
    h_r = fading.magnitudes(cfg_r, fading.init_fading(cfg_r, gen(2), 2048))
    assert h_r.numpy().std() > h.std()


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(pl_exponent=3.0, normalize_gain=False),
                                dict(pl_exponent=2.5, ref_gain_db=-3.0),
                                dict(pl_exponent=0.0, ref_gain_db=2.0)])
def test_path_gain_equals_reference(kw):
    pos = np.float32(np.random.default_rng(1).uniform(0, 300, (12, 2)))
    want = rgeometry.path_gain(rgeometry.GeometryConfig(**kw),
                               jnp.asarray(pos))
    close(geometry.path_gain(geometry.GeometryConfig(**kw),
                             torch.from_numpy(pos)), want)


@pytest.mark.parametrize("fallback", [False, True])
def test_adjacency_and_metropolis_equal_reference(fallback):
    """From the same positions and mask: the unit-disk graph (bitwise) and
    its Metropolis W (rtol 1e-6), doubly stochastic, identity rows for the
    isolated."""
    rng = np.random.default_rng(2)
    for seed in range(4):
        pos = np.float32(rng.uniform(0, 100, (12, 2)))
        mask = rng.uniform(size=12) < 0.7
        kw = dict(area=100.0, comm_radius=25.0)
        radj = rgeometry.adjacency(rgeometry.GeometryConfig(**kw),
                                   jnp.asarray(pos), mask=jnp.asarray(mask),
                                   fallback=fallback)
        adj = geometry.adjacency(geometry.GeometryConfig(**kw),
                                 torch.from_numpy(pos),
                                 mask=torch.from_numpy(mask),
                                 fallback=fallback)
        np.testing.assert_array_equal(adj.numpy(), np.asarray(radj))
        W = geometry.metropolis_weights(adj).numpy()
        close(W, rgeometry.metropolis_weights(radj), atol=1e-7)
        np.testing.assert_allclose(W.sum(0), 1.0, atol=1e-6)
        np.testing.assert_allclose(W, W.T, atol=1e-7)
        assert geometry.connectivity_fraction(adj) == \
            rgeometry.connectivity_fraction(radj)


def test_waypoint_mobility_bounds_and_speed():
    cfg = geometry.GeometryConfig(area=100.0, mobility="waypoint",
                                  speed_min=2.0, speed_max=5.0)
    g = gen(0)
    st = geometry.init_geometry(cfg, g, 24)
    start = st.pos.clone()
    for _ in range(40):
        st2 = geometry.advance(cfg, g, st)
        move = torch.linalg.vector_norm(st2.pos - st.pos, dim=1)
        assert (move <= 5.0 + 1e-4).all()
        assert ((st2.pos >= 0) & (st2.pos <= 100.0)).all()
        assert ((st2.speed >= 2.0) & (st2.speed <= 5.0)).all()
        st = st2
    assert not torch.equal(st.pos, start)
    static = geometry.GeometryConfig(area=100.0, mobility="static")
    s0 = geometry.init_geometry(static, g, 8)
    assert geometry.advance(static, g, s0) is s0


def test_cluster_placement_stays_in_the_area():
    cfg = dataclasses.replace(scenarios.get_scenario("drone_sparse").geometry)
    pos = geometry.init_geometry(cfg, gen(4), 300).pos
    assert ((pos >= 0) & (pos <= cfg.area)).all()
    # three clusters of std 120 m: the spread is well under the area's
    assert pos.std(0).max() < cfg.area / 2


# ---------------------------------------------------------------------------
# churn
# ---------------------------------------------------------------------------


def test_churn_stationary_rate():
    cfg = churn.ChurnConfig(p_drop=0.1, p_join=0.3)
    assert cfg.stationary_up == rchurn.ChurnConfig(
        p_drop=0.1, p_join=0.3).stationary_up == pytest.approx(0.75)
    g = gen(0)
    st = churn.init_churn(cfg, g, 4096)
    ups = []
    for _ in range(30):
        st = churn.advance(cfg, g, st)
        ups.append(float(st.up.mean()))
    assert np.mean(ups) == pytest.approx(0.75, abs=0.03)


def test_churn_min_active_and_stragglers():
    cfg = churn.ChurnConfig(p_drop=1.0, p_join=0.0, min_active=2)
    mask = churn.participation_mask(cfg, gen(0), churn.ChurnState(
        up=torch.zeros(8)))
    assert mask[:2].all() and not mask[2:].any()
    cfg = churn.ChurnConfig(straggler_rate=0.25, min_active=0)
    st = churn.init_churn(cfg, gen(1), 8192)
    assert st.up.all()
    rate = float(churn.participation_mask(cfg, gen(2), st).float().mean())
    assert rate == pytest.approx(0.75, abs=4 * np.sqrt(0.1875 / 8192))
    none = churn.ChurnConfig()
    st = churn.advance(none, gen(3), churn.init_churn(none, gen(3), 16))
    assert churn.participation_mask(none, gen(4), st).all()


# ---------------------------------------------------------------------------
# scenarios and the simulator
# ---------------------------------------------------------------------------


def test_scenarios_are_the_reference_presets():
    assert sorted(scenarios.SCENARIOS) == sorted(rscenarios.SCENARIOS)
    for name, rs in rscenarios.SCENARIOS.items():
        s = scenarios.get_scenario(name)
        for part in ("fading", "geometry", "churn"):
            assert dataclasses.asdict(getattr(s, part)) == \
                dataclasses.asdict(getattr(rs, part)), (name, part)
        assert (s.name, s.description) == (rs.name, rs.description)
        assert s.with_coherence(7).fading.coherence_rounds == 7
    with pytest.raises(KeyError, match="unknown scenario"):
        scenarios.get_scenario("nope")


@pytest.mark.parametrize("target", [
    dict(), dict(target_epsilon=0.7),
    dict(target_total_epsilon=8.0, horizon=50, accountant="rdp"),
    dict(target_total_epsilon=8.0, horizon=50, accountant="composition")])
def test_calibrated_channel_from_replayed_state_equals_reference(target):
    """The simulator's round channel (path gain, fading, alignment and
    each calibration target) from the reference's realized network state
    and W."""
    kw = dict(p_dbm=60.0, gamma=0.05, clip=1.0, **target)
    rsim, rst, _, _, rW = ref_round("iot_dense", 10, 0, **kw)
    sim = simulator.NetworkSimulator(scenarios.get_scenario("iot_dense"), 10,
                                     device="cpu", **kw)
    want = rsim._channel(rst, rW)
    got = sim._channel(port_state(rst), t(rW))
    for f in FIELDS:
        close(getattr(got, f), getattr(want, f), rtol=2e-6)
    if target:
        assert float(got.sigma) != 1.0


@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_scenario_rounds_are_sane(name):
    sim = simulator.NetworkSimulator(scenarios.get_scenario(name), 8,
                                     p_dbm=60.0, device="cpu")
    g = gen(0)
    st = sim.init(g)
    for _ in range(4):
        before = st.geometry.pos.clone()
        st2, chan, mask, W = sim.round(g, st)
        assert torch.equal(st.geometry.pos, before)     # the input is kept
        st = st2
        assert torch.isfinite(chan.h).all() and float(chan.c) > 0
        assert int(mask.sum()) >= 2
        np.testing.assert_allclose(W.sum(0).numpy(), 1.0, atol=1e-5)
        np.testing.assert_allclose(W.sum(1).numpy(), 1.0, atol=1e-5)
        close(chan.signal_scale, chan.c.expand(8), rtol=1e-4)
    chans, masks, Ws = sim.trajectory(g, 5, st)
    assert chans.h.shape == (5, 8) and masks.shape == (5, 8)
    assert Ws.shape == (5, 8, 8)


def test_static_paper_reduces_to_the_static_channel():
    """static_paper: one draw held forever, the complete graph, no churn;
    its channel is the static channel's rule applied to that draw, and
    the round's W is the paper's W."""
    sim = simulator.NetworkSimulator(scenarios.get_scenario("static_paper"),
                                     8, p_dbm=60.0, sigma=0.7, sigma_m=0.4,
                                     device="cpu")
    chans, masks, Ws = sim.trajectory(gen(0), 10)
    assert torch.equal(chans.h, chans.h[:1].expand(10, 8))
    assert masks.all()
    want = (np.ones((8, 8)) - np.eye(8)) / 7
    close(Ws[3], want, atol=1e-7)
    alpha, beta, c = fading.align(chans.h[0], chans.P[0])
    close(chans.alpha[5], alpha)
    close(chans.beta[5], beta)
    assert float(chans.c[9]) == float(c)
    assert float(chans.sigma[0]) == pytest.approx(0.7)
    assert float(chans.sigma_m[0]) == pytest.approx(0.4)


def test_simulator_refuses_what_is_not_ported():
    scn = scenarios.get_scenario("mesh_sparse")
    # sparse_k is ported (ROADMAP A10): a round's W is the neighbor list
    sim = simulator.NetworkSimulator(scn, 16, sparse_k=4, device="cpu")
    st, _, _, W = sim.round(gen(0), sim.init(gen(0)))
    assert isinstance(W, SparseW) and W.idx.shape == (16, 4)
    with pytest.raises(ValueError, match="exceeds n_workers"):
        simulator.NetworkSimulator(scn, 16, sparse_k=17, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        simulator.NetworkSimulator(scn, 16, target_epsilon=1.0,
                                   target_total_epsilon=4.0, horizon=10,
                                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            simulator.NetworkSimulator(scn, 16)
