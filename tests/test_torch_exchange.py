"""The port's exchange engine (``repro_torch.core.exchange``, ``dwfl``,
``baselines``) against the reference's on the CPU: ``mix_exchange``, the
four static scheme runners with the reference's realized ``jax.random``
normals replayed, ``resolve_spec`` routing, the orthogonal and the
ring/torus calibration, the scheme-aware ``epsilon_report`` and the
Eqt. (8) oracle. The port's own generator draws are checked in
distribution.

Tolerance: both packages compute in float32 and differ only in the order
of the N-term mixing sum, |port - ref| <= N 2^-24 (|x| + |n/c|) per term;
the tests use atol = 1e-6 * scale, scale the largest term. The
distribution checks use 4 standard errors of the variance over ~10^5
draws (relative 2% for the variance, bounds stated in each test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dwfl as rdwfl
from repro.core import exchange as RX
from repro.core import privacy as rpriv
from repro.core import protocol as RP
from repro.core.channel import ChannelConfig as RefChannelConfig
from repro_torch.core import baselines, dwfl
from repro_torch.core import exchange as X
from repro_torch.core import privacy
from repro_torch.core import protocol as P
from repro_torch.core.channel import ChannelConfig
from test_torch_protocol import ref_normals

N = 5
CHAN = dict(n_workers=N, p_dbm=30.0, sigma=0.7, sigma_m=0.4, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.normal(size=(n, 7, 3)).astype(np.float32),
                        "b": rng.normal(size=(n, 3)).astype(np.float32)},
                       {"w": rng.normal(size=(n, 3, 2)).astype(np.float32),
                        "b": rng.normal(size=(n, 2)).astype(np.float32)}]}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _flat(tree):
    return np.concatenate([np.asarray(l, np.float32).reshape(N, -1)
                           for l in jax.tree_util.tree_leaves(tree)], axis=1)


def _close(got, want, scale=1.0):
    np.testing.assert_allclose(_flat(got), _flat(want), rtol=0,
                               atol=1e-6 * (scale + np.abs(_flat(want)).max()))


def _chans():
    return RefChannelConfig(**CHAN).realize(), ChannelConfig(**CHAN).realize()


def _doubly_stochastic(seed):
    rng = np.random.default_rng(seed)
    lam = rng.dirichlet(np.ones(3))
    W = sum(l * np.eye(N)[rng.permutation(N)] for l in lam)
    return (0.5 * (W + W.T)).astype(np.float32)


@pytest.mark.parametrize("variant", ["plain", "self_m_listen", "scalars"])
def test_mix_exchange_matches_reference(variant):
    x, n, m = _tree(0), _tree(1), _tree(2)
    W = _doubly_stochastic(4)
    rng = np.random.default_rng(5)
    kw = {"plain": {},
          "self_m_listen": dict(
              self_scale=rng.uniform(size=N).astype(np.float32),
              m_scale=rng.uniform(size=N).astype(np.float32),
              listen=(rng.uniform(size=N) > 0.3).astype(np.float32)),
          "scalars": dict(self_scale=0.0, m_scale=0.25)}[variant]
    want = RX.mix_exchange(_jax(x), _jax(n), _jax(m), 1.7, 0.4, W,
                           **{k: (v if np.isscalar(v) else jnp.asarray(v))
                              for k, v in kw.items()})
    got = X.mix_exchange(_torch(x), _torch(n), _torch(m), 1.7, 0.4,
                         torch.from_numpy(W),
                         **{k: (v if np.isscalar(v) else torch.from_numpy(v))
                            for k, v in kw.items()})
    _close(got, want)


@pytest.mark.parametrize("scheme", ["dwfl", "gossip", "orthogonal",
                                    "centralized"])
def test_scheme_runners_match_reference(scheme):
    """Each spec's run on the reference's keys vs the port's run on the
    reference's realized normals (the train step's split: k_n, k_m, k_x)."""
    kw = dict(scheme=scheme, n_workers=N, eta=0.4, p_dbm=30.0, sigma=0.7,
              sigma_m=0.4, seed=3)
    rproto, proto = RP.ProtocolConfig(**kw), P.ProtocolConfig(**kw)
    rchan, chan = rproto.channel(), proto.channel()
    x = _tree(6)
    key = jax.random.PRNGKey(21)
    rspec, spec = RX.resolve_spec(rproto), X.resolve_spec(proto)
    want = rspec.run(_jax(x), jax.random.split(key, 3), rchan, rproto)
    plan = spec.plan(proto, chan, "cpu")
    got = spec.run(_torch(x), ref_normals(scheme, _jax(x), key), plan, proto)
    _close(got, want, scale=float(np.abs(plan.amp.numpy()).max()
                                  / float(plan.c)) * 5.42 + 1.0)


def test_dwfl_facades_match_reference():
    rchan, chan = _chans()
    x, n, m = _tree(7), _tree(8), _tree(9)
    _close(dwfl.exchange_dwfl(_torch(x), _torch(n), _torch(m), chan, 0.4),
           rdwfl.exchange_dwfl(_jax(x), _jax(n), _jax(m), rchan, 0.4),
           scale=10.0)
    key = jax.random.PRNGKey(2)
    G = ref_normals("orthogonal", _jax(x), key)
    k_x = jax.random.split(key, 3)[2]
    _close(baselines.exchange_orthogonal(_torch(x), G, chan, 0.4),
           rdwfl.exchange_orthogonal(_jax(x), k_x, rchan, 0.4), scale=10.0)
    G = ref_normals("centralized", _jax(x), key)
    k_m = jax.random.split(key, 3)[1]
    _close(baselines.exchange_centralized(_torch(x), _torch(n), G["m"], chan),
           rdwfl.exchange_centralized(_jax(x), _jax(n), k_m, rchan),
           scale=10.0)


def test_matrix_form_reference_equals_reference_and_the_engine():
    rchan, chan = _chans()
    rng = np.random.default_rng(10)
    Xf, G, n, m = (rng.normal(size=(N, 40)) for _ in range(4))
    for W in (None, _doubly_stochastic(11)):
        want = rdwfl.matrix_form_reference(Xf, G, n, m, rchan, 0.05, 0.4, W=W)
        got = dwfl.matrix_form_reference(Xf, G, n, m, chan, 0.05, 0.4, W=W)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # the engine's complete-graph exchange after the local step is Eqt. (8)
    x1 = {"flat": torch.from_numpy((Xf - 0.05 * G).astype(np.float32))}
    out = dwfl.exchange_dwfl(x1, {"flat": torch.from_numpy(
        n.astype(np.float32))}, {"flat": torch.from_numpy(
            m.astype(np.float32))}, chan, 0.4)
    want = dwfl.matrix_form_reference(Xf, G, n, m, chan, 0.05, 0.4)
    np.testing.assert_allclose(out["flat"].numpy(), want, rtol=0,
                               atol=1e-5 * (1.0 + np.abs(want).max()))


@pytest.mark.parametrize("kw,name", [
    (dict(scheme="dwfl", topology="ring"), "topology"),
    (dict(scheme="dwfl", participation=0.5), "sampled")])
def test_resolve_spec_routes_like_the_reference(kw, name):
    for scheme in ("dwfl", "gossip", "orthogonal", "centralized"):
        rs = RX.resolve_spec(RP.ProtocolConfig(scheme=scheme))
        s = X.resolve_spec(P.ProtocolConfig(scheme=scheme))
        assert (s.name, s.fuse_ok) == (rs.name, rs.fuse_ok)
        assert (rs.plan is not None) == s.fuse_ok
    rs, s = RX.resolve_spec(RP.ProtocolConfig(**kw)), \
        X.resolve_spec(P.ProtocolConfig(**kw))
    assert (s.name, s.fuse_ok) == (rs.name, rs.fuse_ok) == (name, True)
    rs = RX.resolve_spec(RP.ProtocolConfig(**kw), dynamic=True)
    s = X.resolve_spec(P.ProtocolConfig(**kw), dynamic=True)
    assert s.name == rs.name == "dynamic"
    s = X.resolve_spec(P.ProtocolConfig(), axis="data")
    rs = RX.resolve_spec(RP.ProtocolConfig(), axis="data")
    assert (s.name, s.fuse_ok) == (rs.name, rs.fuse_ok) == ("collective",
                                                           True)
    rs = RX.resolve_spec(RP.ProtocolConfig(sparse_neighbors=4), dynamic=True)
    s = X.resolve_spec(P.ProtocolConfig(sparse_neighbors=4), dynamic=True)
    assert (s.name, s.fuse_ok) == (rs.name, rs.fuse_ok) == ("dynamic_sparse",
                                                           True)
    assert s.plan is X.plan_dynamic_sparse
    with pytest.raises(ValueError, match="scheme='dwfl'"):
        X.resolve_spec(P.ProtocolConfig(scheme="gossip"), dynamic=True)
    with pytest.raises(ValueError, match="mixing-family"):
        P.ProtocolConfig(scheme="orthogonal").plan(
            P.ProtocolConfig(scheme="orthogonal").channel(), "cpu")


@pytest.mark.parametrize("eps", [0.3, 1.0, 4.0])
def test_orthogonal_calibration_equals_reference(eps):
    rchan, chan = _chans()
    args = (eps, 0.02, 1.0)
    assert privacy.sigma_for_epsilon_orthogonal(*args, chan, 1e-5) == \
        rpriv.sigma_for_epsilon_orthogonal(*args, rchan, 1e-5)
    np.testing.assert_array_equal(
        privacy.epsilon_dwfl_bound(0.02, 1.0, chan, 1e-5),
        rpriv.epsilon_dwfl_bound(0.02, 1.0, rchan, 1e-5))


@pytest.mark.parametrize("scheme", ["dwfl", "gossip", "orthogonal",
                                    "centralized"])
def test_scheme_aware_channel_and_report_equal_reference(scheme):
    kw = dict(scheme=scheme, n_workers=6, gamma=0.01, eta=0.4,
              target_epsilon=0.8, seed=2)
    proto, rproto = P.ProtocolConfig(**kw), RP.ProtocolConfig(**kw)
    chan, rchan = proto.channel(), rproto.channel()
    assert chan.cfg.sigma == rchan.cfg.sigma
    rep, rrep = P.epsilon_report(proto, chan), RP.epsilon_report(rproto, rchan)
    assert set(rep) == {"epsilon_per_worker", "epsilon_worst",
                        "epsilon_complete_graph_worst",
                        "epsilon_orthogonal_worst", "sigma"}
    for k in rep:
        np.testing.assert_array_equal(rep[k], rrep[k])
    # the calibrated scheme's own worst budget is the target
    assert rep["epsilon_worst"] == pytest.approx(0.8, rel=1e-9)


@pytest.mark.parametrize("topology,n", [("ring", 10), ("torus", 9)])
def test_dwfl_topology_calibration_and_report_equal_reference(topology, n):
    """A dwfl run on a ring or torus: sigma calibrated and epsilon quoted
    with the topology's formulas (each receiver masked by its neighbors
    only), as the reference does — more noise than the complete graph's
    calibration gives, which would understate the budget (C5)."""
    kw = dict(scheme="dwfl", n_workers=n, topology=topology,
              target_epsilon=0.1)
    proto, rproto = P.ProtocolConfig(**kw), RP.ProtocolConfig(**kw)
    chan, rchan = proto.channel(), rproto.channel()
    assert chan.cfg.sigma == rchan.cfg.sigma
    assert chan.cfg.sigma > P.ProtocolConfig(
        n_workers=n, target_epsilon=0.1).channel().cfg.sigma
    for T in (None, 64):
        rep = P.epsilon_report(proto, chan, T=T)
        rrep = RP.epsilon_report(rproto, rchan, T=T)
        assert set(rep) == set(rrep)
        for k in rep:
            np.testing.assert_array_equal(rep[k], rrep[k])
    assert rep["epsilon_worst"] == pytest.approx(0.1, rel=1e-9)
    W = proto.mixing_matrix()
    np.testing.assert_array_equal(
        privacy.epsilon_dwfl_topology(0.05, 1.0, chan, 1e-5, W),
        rpriv.epsilon_dwfl_topology(0.05, 1.0, rchan, 1e-5, W))
    assert privacy.sigma_for_epsilon_topology(0.3, 0.05, 1.0, chan, 1e-5, W) \
        == rpriv.sigma_for_epsilon_topology(0.3, 0.05, 1.0, rchan, 1e-5, W)


@pytest.mark.parametrize("scheme,topology", [
    ("dwfl", "complete"), ("gossip", "ring"), ("orthogonal", "ring"),
    ("centralized", "ring")])
@pytest.mark.parametrize("eps", [0.1, 0.5])
def test_complete_graph_calibration_and_report_equal_reference(scheme,
                                                               topology, eps):
    """The complete graph, and the schemes whose budget does not read the
    topology: channel().sigma and epsilon_report are the reference's."""
    kw = dict(scheme=scheme, topology=topology, n_workers=10,
              target_epsilon=eps)
    proto, rproto = P.ProtocolConfig(**kw), RP.ProtocolConfig(**kw)
    chan, rchan = proto.channel(), rproto.channel()
    assert chan.cfg.sigma == rchan.cfg.sigma
    rep, rrep = P.epsilon_report(proto, chan), RP.epsilon_report(rproto, rchan)
    for k in rep:
        np.testing.assert_array_equal(rep[k], rrep[k])
    assert rep["epsilon_worst"] == pytest.approx(eps, rel=1e-9)


def _zero_round(scheme, seed=0):
    """One exchange of an all-zero tree (one [N, 20000] leaf) on the
    port's own generator draws: the output is the noise alone."""
    proto = P.ProtocolConfig(scheme=scheme, n_workers=N, eta=0.4,
                             p_dbm=30.0, sigma=0.7, sigma_m=0.4, seed=3)
    spec = X.resolve_spec(proto)
    plan = spec.plan(proto, proto.channel(), "cpu")
    Xz = {"flat": torch.zeros((N, 20000))}
    G = X.draw_normals(Xz, torch.Generator().manual_seed(seed),
                       shared_m=spec.shared_m)
    return spec.run(Xz, G, plan, proto)["flat"].double().numpy(), plan, G


def test_generator_draws_in_distribution():
    G = X.draw_normals({"flat": torch.zeros((N, 20000))},
                       torch.Generator().manual_seed(1))
    for f in ("n", "m"):
        v = G[f]["flat"].double().numpy()
        assert abs(v.mean()) < 4 / np.sqrt(v.size)
        assert v.var() == pytest.approx(1.0, rel=4 * np.sqrt(2 / v.size))
    np.testing.assert_array_less(
        np.abs(np.corrcoef(G["n"]["flat"].reshape(-1).numpy(),
                           G["m"]["flat"].reshape(-1).numpy())[0, 1]), 0.01)


@pytest.mark.parametrize("scheme", ["dwfl", "orthogonal", "centralized"])
def test_scheme_noise_variance_per_receiver(scheme):
    """Per receiver i, the noise-only update has the variance the plan
    implies: eta^2 [sum_k (W_ik - self_i d_ik)^2 amp_k^2 / c^2
    + (m_scale_i sigma_m)^2]; the centralized server's m is one draw that
    every receiver shares, so all receivers' outputs are equal."""
    out, plan, G = _zero_round(scheme)
    W = plan.W.double().numpy()
    amp = plan.amp.double().numpy() / float(plan.c)
    eta = 1.0 if scheme == "centralized" else 0.4
    selfs = 1.0 if plan.self_scale is None else float(plan.self_scale)
    ms = (1.0 if plan.m_scale is None else
          np.broadcast_to(np.asarray(plan.m_scale, np.float64), (N,)))
    A = W - selfs * np.eye(N)
    want = eta ** 2 * ((A ** 2) @ amp ** 2
                       + (np.asarray(ms) * float(plan.sigma_m)) ** 2)
    np.testing.assert_allclose(out.var(axis=1), want,
                               rtol=4 * np.sqrt(2 / out.shape[1]))
    assert np.abs(out.mean(axis=1)).max() < 4 * np.sqrt(want.max()
                                                        / out.shape[1])
    if scheme == "centralized":
        assert G["m"]["flat"].shape == (1, 20000)
        np.testing.assert_allclose(out, np.broadcast_to(out[:1], out.shape),
                                   rtol=0, atol=1e-6 * np.abs(out).max())


def test_gossip_draws_nothing_and_only_mixes():
    proto = P.ProtocolConfig(scheme="gossip", n_workers=N, eta=0.4)
    spec = X.resolve_spec(proto)
    plan = spec.plan(proto, proto.channel(), "cpu")
    assert not plan.noisy
    x = _torch(_tree(12))
    out = spec.run(x, None, plan, proto)
    W = plan.W.numpy().astype(np.float64)
    xf = _flat(x).astype(np.float64)
    np.testing.assert_allclose(_flat(out), xf + 0.4 * (W @ xf - xf),
                               rtol=0, atol=1e-6 * np.abs(xf).max())
