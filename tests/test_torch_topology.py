"""Gossip topologies and sampled participation on the port (ROADMAP A4)
against the reference on the CPU.

``core.topology`` is numpy float64 in both packages, the same operations:
equal. The plans (``plan_topology``, ``plan_sampled``) and their matrices
(``masked_complete_W``, ``sampled_W``) are float32 from the same mask or
W: rtol 1e-6. One flat round (``make_flat_train_step``: the fused dp_mix
round's plain twin on the CPU) and one worker-tree round
(``make_train_step``) on a ring and under sampled participation, from the
reference's parameters, batch, noise seed or normals and realized mask:
atol 1e-6 * (1 + max|x|), as tests/test_torch_protocol.py holds the
complete graph's. The port's own participation draws are checked in
distribution: every worker's realized rate is
``effective_participation(q, N)`` within 4 standard errors (4,000 rounds).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import exchange as RX
from repro.core import protocol as RP
from repro.core import topology as rtopology
from repro_torch.configs import DWFL_PAPER
from repro_torch.convert import params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import topology
from repro_torch.data import ClassificationStore, classification_dataset, dirichlet_partition
from repro_torch.kernels.dp_mix import ops
from test_torch_protocol import ref_normals

N, B, HIDDEN = 4, 8, 16
ROUND_TOL = 1e-6
KW = dict(n_workers=N, gamma=0.01, eta=0.4, clip=1.0, target_epsilon=0.0,
          sigma=0.5)
CASES = {"ring": dict(topology="ring"), "sampled": dict(participation=0.5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind,n,kw", [("complete", 6, {}),
                                       ("ring", 8, {"k": 1}),
                                       ("ring", 9, {"k": 2}),
                                       ("torus", 9, {}),
                                       ("torus", 12, {"rows": 3})])
def test_topology_matrices_and_spectra_equal_reference(kind, n, kw):
    W, rW = topology.make(kind, n, **kw), rtopology.make(kind, n, **kw)
    np.testing.assert_array_equal(W, rW)
    assert topology.check_doubly_stochastic(W)
    np.testing.assert_array_equal(topology.degrees(W), rtopology.degrees(rW))
    for eta in (0.3, 0.7):
        assert topology.contraction(W, eta) == rtopology.contraction(rW, eta)
    assert topology.optimal_eta(W) == rtopology.optimal_eta(rW)
    proto = P.ProtocolConfig(n_workers=n, topology=kind,
                             topology_k=kw.get("k", 1))
    if "rows" not in kw:
        np.testing.assert_array_equal(proto.mixing_matrix(), W)


def test_topology_make_refuses():
    with pytest.raises(ValueError):
        topology.make("torus", 10, rows=3)
    with pytest.raises(ValueError):
        topology.make("star", 4)


@pytest.mark.parametrize("n_active", [8, 5, 2, 1])
def test_masked_complete_and_sampled_W_equal_reference(n_active):
    rng = np.random.default_rng(n_active)
    mask = np.zeros(8, bool)
    mask[rng.permutation(8)[:n_active]] = True
    np.testing.assert_allclose(X.masked_complete_W(torch.from_numpy(mask)),
                               RX.masked_complete_W(mask), rtol=1e-6)
    for got, want in zip(X.sampled_W(torch.from_numpy(mask)),
                         RX.sampled_W(mask)):
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _plans_close(plan, rplan):
    for f in ("W", "c", "amp", "sigma_m", "self_scale", "m_scale", "listen"):
        got, want = getattr(plan, f), getattr(rplan, f)
        assert (got is None) == (want is None), f
        if want is not None:
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-6, err_msg=f)
    assert plan.noisy == rplan.noisy


@pytest.mark.parametrize("topo,n", [("ring", 10), ("torus", 9)])
def test_topology_plan_equals_reference(topo, n):
    kw = dict(n_workers=n, topology=topo, target_epsilon=0.4, p_dbm=30.0)
    proto, rproto = P.ProtocolConfig(**kw), RP.ProtocolConfig(**kw)
    plan = X.plan_topology(proto, proto.channel(), "cpu")
    _plans_close(plan, RX.plan_topology(rproto, rproto.channel()))
    W = np.float32(topology.ring(n, 2))
    _plans_close(X.plan_topology(proto, proto.channel(), "cpu", W),
                 RX.plan_topology(rproto, rproto.channel(), W_arg=W))


def test_sampled_plan_equals_reference_on_the_replayed_mask():
    kw = dict(n_workers=8, participation=0.4, p_dbm=30.0, sigma=0.7)
    proto, rproto = P.ProtocolConfig(**kw), RP.ProtocolConfig(**kw)
    key = jax.random.PRNGKey(4)
    rmask = RP.sample_participation(key, 8, 0.4)
    rplan = RX.plan_sampled(rproto, rproto.channel(), key)
    plan = X.plan_sampled(proto, proto.channel(), "cpu",
                          torch.from_numpy(np.array(rmask)))
    _plans_close(plan, rplan)
    with pytest.raises(ValueError, match="participation mask"):
        X.plan_sampled(proto, proto.channel(), "cpu")


@pytest.mark.parametrize("q,n", [(0.3, 8), (0.05, 20)])
def test_participation_rate_equals_effective_participation(q, n):
    assert P.effective_participation(q, n) == RP.effective_participation(q, n)
    assert P.effective_participation(1.0, n) == 1.0
    g = torch.Generator().manual_seed(0)
    masks = torch.stack([P.sample_participation(g, n, q)
                         for _ in range(4000)]).double()
    assert (masks.sum(1) >= 2).all()
    q_eff = P.effective_participation(q, n)
    rate = masks.mean(0).numpy()
    np.testing.assert_allclose(rate, q_eff,
                               atol=4 * np.sqrt(q_eff * (1 - q_eff) / 4000))


def _ref_flat(seed, kw):
    """Reference flat step, buffer and store; the port's on the same
    numbers (tests/test_torch_train.py's setup)."""
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    wp = RP.init_worker_params(jax.random.PRNGKey(seed), rcfg, N)
    rspec = RX.FlatSpec(wp)
    rstep = jax.jit(RP.make_flat_train_step(rcfg, RP.ProtocolConfig(**kw),
                                            rspec.unravel_row))
    flat, tree, spec = params_from_jax(jax.tree_util.tree_map(np.asarray, wp),
                                       device="cpu")
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    x, y = classification_dataset(400, seed=seed)
    parts = dirichlet_partition(y, N, seed=seed)
    from repro.data import device as ref_device
    rstore = ref_device.ClassificationStore.build(x, y, parts, B)
    store = ClassificationStore.build(x, y, parts, B, device="cpu")
    return rstep, rspec.flatten(wp), rstore, cfg, spec, flat, store


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_flat_round_matches_reference(case):
    kw = dict(KW, **CASES[case])
    rstep, rflat, rstore, cfg, spec, flat, store = _ref_flat(0, kw)
    step = P.make_flat_train_step(cfg, P.ProtocolConfig(**kw), spec, "cpu")
    key = jax.random.PRNGKey(11)
    k_data, k_step = jax.random.split(key)
    rout, rm = rstep(rflat, rstore.sample(k_data), k_step)
    k_n, _, k_x = jax.random.split(k_step, 3)
    mask = torch.from_numpy(np.array(RP.sample_participation(k_x, N, 0.5)))
    u = torch.from_numpy(np.array(jax.random.uniform(k_data, (N, B))))
    before = ops.dp_mix_round.launches
    out, m = step(flat, store.sample(u), ops.seed_from_key(np.asarray(k_n)),
                  mask=mask)
    assert ops.dp_mix_round.launches == before      # the CPU's plain twin
    want = np.asarray(rout)
    err = float(np.abs(out.numpy() - want).max())
    assert err < ROUND_TOL * (1.0 + float(np.abs(want).max())), err
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_tree_round_matches_reference(case):
    from test_torch_protocol import _batch, _both, _flat, _port_flat
    kw = dict(KW, **CASES[case])
    rstep, rwp, step, wp, batcher = _both("dwfl", False, base=kw)
    rb, tb = _batch(batcher)
    key = jax.random.PRNGKey(7)
    rout, _ = rstep(rwp, rb, key)
    mask = torch.from_numpy(np.array(RP.sample_participation(
        jax.random.split(key, 3)[2], N, 0.5)))
    out, _ = step(wp, tb, None, normals=ref_normals("dwfl", rwp, key),
                  mask=mask)
    want, got = _flat(rout), _port_flat(out)
    err = float(np.abs(got - want).max())
    assert err < ROUND_TOL * (1.0 + float(np.abs(want).max())), err


def test_sampled_round_draws_its_mask_from_the_generator():
    """Without ``mask`` the flat step draws the round's mask from the
    generator it is given: the same generator state replayed as the mask
    gives the same round."""
    kw = dict(KW, participation=0.5)
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    wp = P.init_worker_params(torch.Generator().manual_seed(1), cfg, N, "cpu")
    spec = X.FlatSpec(wp)
    step = P.make_flat_train_step(cfg, P.ProtocolConfig(**kw), spec, "cpu")
    x, y = classification_dataset(400, seed=1)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, N, seed=1),
                                      B, device="cpu")
    batch = store.draw(torch.Generator().manual_seed(2))
    out, _ = step(spec.flatten(wp), batch, 5,
                  generator=torch.Generator().manual_seed(3))
    mask = P.sample_participation(torch.Generator().manual_seed(3), N, 0.5)
    again, _ = step(spec.flatten(wp), batch, 5, mask=mask)
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    with pytest.raises(ValueError, match="participation mask"):
        step(spec.flatten(wp), batch, 5)      # neither mask nor generator


def _facade_tree(seed, n):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 7, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32)}


@pytest.mark.parametrize("facade", ["topology", "dynamic", "dynamic_sparse",
                                    "sampled"])
def test_dwfl_facades_equal_reference(facade):
    """core.dwfl's exchange_dwfl_topology, exchange_dwfl_dynamic (a dense W,
    and a neighbor list) and exchange_dwfl_sampled against the
    reference's on the same parameters and replayed noise, the channel
    and W (or mask) replayed: atol ROUND_TOL * (1 + max|x|)."""
    from repro.core import dwfl as rdwfl
    from repro.core.channel import ChannelConfig as RefChannelConfig
    from repro_torch.core import dwfl
    from repro_torch.core.channel import ChannelConfig
    from test_torch_net import port_chan, ref_round, t
    from test_torch_sparse import port_sw
    n = 8
    Xn, nn, mn = (_facade_tree(s, n) for s in (0, 1, 2))
    jx = lambda tr: jax.tree_util.tree_map(jax.numpy.asarray, tr)
    tx = lambda tr: {k: torch.from_numpy(v) for k, v in tr.items()}
    chan_kw = dict(n_workers=n, p_dbm=30.0, sigma=0.7, sigma_m=0.4, seed=3)
    rchan, chan = (RefChannelConfig(**chan_kw).realize(),
                   ChannelConfig(**chan_kw).realize())
    if facade == "topology":
        W = topology.make("ring", n, k=2)
        want = rdwfl.exchange_dwfl_topology(jx(Xn), jx(nn), jx(mn), rchan,
                                            0.4, W)
        got = dwfl.exchange_dwfl_topology(tx(Xn), tx(nn), tx(mn), chan, 0.4,
                                          W)
    elif facade == "sampled":
        mask = np.array([1, 0, 1, 1, 0, 1, 1, 0], bool)
        want = rdwfl.exchange_dwfl_sampled(jx(Xn), jx(nn), jx(mn), rchan,
                                           0.4, jax.numpy.asarray(mask))
        got = dwfl.exchange_dwfl_sampled(tx(Xn), tx(nn), tx(mn), chan, 0.4,
                                         torch.from_numpy(mask))
    else:
        sparse = facade == "dynamic_sparse"
        _, _, rchan, _, rW = ref_round("iot_dense", n, 7, rounds=2,
                                       sigma=0.5, sigma_m=0.3, p_dbm=30.0,
                                       sparse_k=3 if sparse else 0)
        if sparse:   # the reference's facade builds the dense plan only
            want = RX.run_mix(jx(Xn), jx(nn), jx(mn), 0.4,
                              RX.plan_dynamic_sparse(None, rchan, W_arg=rW))
            W = port_sw(rW)
        else:
            want = rdwfl.exchange_dwfl_dynamic(jx(Xn), jx(nn), jx(mn), rchan,
                                               0.4, rW)
            W = t(rW)
        got = dwfl.exchange_dwfl_dynamic(tx(Xn), tx(nn), tx(mn),
                                         port_chan(rchan), 0.4, W)
    for k in ("w", "b"):
        w_ = np.asarray(want[k])
        err = float(np.abs(got[k].numpy() - w_).max())
        assert err < ROUND_TOL * (1.0 + float(np.abs(w_).max())), (k, err)
