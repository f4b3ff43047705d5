"""The fleet's sparse round on the port (ROADMAP A20): R networks, each
mixing through its own neighbor list, in one round.

* The graph: the stacked build (``geometry.sparse_metropolis`` over [R, N,
  2] positions and [R, N] masks) bitwise R single builds, and against the
  reference's ``jax.vmap(sim.round)`` list on its replayed positions and
  masks: idx and w bitwise, self_w within 1 ULP (1 - sum w over the k
  slots, which XLA may sum in another order; as tests/test_torch_sparse.py
  holds the single build).
* The plan: ``plan_dynamic_sparse`` over the stacked list against the
  reference's vmapped plan (rtol 1e-6) and bitwise the dense fleet plan's
  listen and m_scale.
* The round: the plain sparse round over [R, N, d] bitwise R single
  rounds; the fleet's sparse rounds at R = 1 bitwise the single sparse
  network's, flat and tree; at R = 3, N = 16, k = 4 against the
  reference's vmapped fleet step on its replayed operands (its stacked
  channels and lists, the [R, N, ...] parameters, the batch's uniforms
  and each replicate's noise: the int32 seed ``seed_from_key`` of its step
  key, or its ``jax.random`` normals on the tree path), within the
  sparse round's tolerance: atol 1e-6 * scale, scale = 1 + max|x| + 5.42
  max|amp/c| (tests/test_torch_sparse.py's).
* ``stack_rounds``, ``fleet_epsilon_report`` and ``fleet_round_telemetry``
  on stacked lists: the reference's report within rtol 2e-6 (its float32
  budgets rtol 1e-6, their float64 composition inherits it, as
  tests/test_torch_fleet.py holds the dense one); the dense formula of
  the same lists within rtol 1e-5 (the masking sums add in another
  order).
* No [N, N] tensor in a fleet sparse round; the CLI on the CPU.
* On a card (``gpu``-marked, skipped here): the replicate axis of the
  sparse kernels bitwise R separate launches and within the plain twin's
  tolerance (tests/test_torch_cuda.py's sparse one).

JAX is imported inside the tests that hold the port against the
reference, so the ``gpu`` case runs where JAX is not installed:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_fleet_sparse.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, classification_dataset,
                              dirichlet_partition)
from repro_torch.fleet import (FleetEngine, fleet_epsilon_report,
                               fleet_round_telemetry, stack_rounds)
from repro_torch.kernels.dp_mix import ops
from repro_torch.kernels.dp_mix.dp_mix import dp_mix_sparse_plain
from repro_torch.net import geometry as G
from repro_torch.net.sparse import SparseW
from repro_torch.net.state import FIELDS, TracedChannelState
from repro_torch.obs import telemetry as tele

R, N, B, K, HIDDEN = 3, 16, 8, 4, 16
KW = dict(scheme="dwfl", n_workers=N, gamma=0.01, eta=0.4, clip=1.0,
          target_epsilon=0.0, sigma=0.5, sigma_m=0.3, p_dbm=30.0,
          channel_model="dynamic", scenario="iot_dense", sparse_neighbors=K)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)


def _store(n=N, seed=1):
    x, y = classification_dataset(400, seed=seed)
    parts = dirichlet_partition(y, n, seed=seed)
    return ClassificationStore.build(x, y, parts, B, device="cpu"), (x, y,
                                                                     parts)


def t(a):
    """A reference array as a CPU tensor."""
    return torch.from_numpy(np.array(a))


def port_chan(rchan) -> TracedChannelState:
    return TracedChannelState(**{f: t(getattr(rchan, f)) for f in FIELDS},
                              n_workers=rchan.n_workers)


def port_sw(sw) -> SparseW:
    return SparseW(t(sw.idx), t(sw.w), t(sw.self_w))


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _scale(plan, want):
    return 1.0 + float(np.abs(want).max()) + 5.42 * float(
        (plan.amp / plan.c[:, None]).abs().max())


def _ref_fleet_round(seed=3, rounds=2):
    """The reference's fleet (R networks, neighbor lists), its round
    compiled once, after ``rounds`` rounds: (proto, engine, state, chans,
    masks, Ws)."""
    import jax
    from repro.core import protocol as RP
    from repro.fleet import engine as rengine
    rproto = RP.ProtocolConfig(**KW, replicates=R)
    rfleet = rengine.FleetEngine(rproto)
    step = jax.jit(rfleet.round)
    st = rfleet.init(jax.random.PRNGKey(seed))
    for i in range(rounds):
        st, chans, masks, Ws = step(jax.random.PRNGKey(seed + 10 + i), st)
    return rproto, rfleet, st, chans, masks, Ws


@pytest.fixture(scope="module")
def ref_round():
    return _ref_fleet_round()


# ---------------------------------------------------------------------------
# the graph and the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fallback,block", [(False, 0), (True, 5),
                                            (False, 16), (True, 0)])
def test_stacked_build_is_r_single_builds(fallback, block):
    gen = torch.Generator().manual_seed(int(fallback) + block)
    pos = torch.rand((R, 40, 2), generator=gen) * 100.0
    pos[1, 3] = 1e4                                  # one isolated worker
    mask = torch.rand((R, 40), generator=gen) > 0.2
    cfg = G.GeometryConfig(area=100.0, comm_radius=25.0)
    stacked = G.sparse_metropolis(cfg, pos, 6, mask=mask, fallback=fallback,
                                  block=block)
    assert stacked.idx.shape == (R, 40, 6) and stacked.idx.dtype == torch.int32
    for r in range(R):
        one = G.sparse_metropolis(cfg, pos[r], 6, mask=mask[r],
                                  fallback=fallback, block=block)
        for f in ("idx", "w", "self_w"):
            assert torch.equal(getattr(stacked, f)[r], getattr(one, f)), f
    idx, valid = G._block_topk(pos, 6, radius=25.0, mask=mask, block=block)
    for r in range(R):
        i1, v1 = G._block_topk(pos[r], 6, radius=25.0, mask=mask[r],
                               block=block)
        assert torch.equal(valid[r], v1)
        assert torch.equal(torch.where(v1, idx[r], -1),
                           torch.where(v1, i1, -1))


def test_stacked_build_equals_the_reference_s_vmapped_round(ref_round):
    """The reference's vmapped round built each network's list from its
    positions and mask; the port's one call on them replayed gives them."""
    _, _, rst, _, rmasks, rWs = ref_round
    sim = P.ProtocolConfig(**KW).simulator("cpu")
    got = G.sparse_metropolis(sim.scenario.geometry, t(rst.geometry.pos), K,
                              mask=t(rmasks), fallback=sim.graph_fallback,
                              block=sim.graph_block)
    assert got.idx.shape == (R, N, K)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(rWs.idx))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(rWs.w))
    assert _ulps(got.self_w, rWs.self_w).max() <= 1
    assert (got.off_degree() > 0).any() and (got.off_degree() == 0).any()


def test_fleet_sparse_plan_equals_the_reference_s_and_the_dense_plan(
        ref_round):
    import jax
    from repro.core import exchange as RX
    rproto, _, _, rchans, _, rWs = ref_round
    chans, sw = port_chan(rchans), port_sw(rWs)
    proto = P.ProtocolConfig(**KW, replicates=R)
    plan = X.plan_dynamic_sparse(proto, chans, "cpu", sw)
    rplan = jax.vmap(lambda c, w: RX.plan_dynamic_sparse(rproto, c,
                                                         W_arg=w))(rchans,
                                                                   rWs)
    assert isinstance(plan.W, SparseW) and plan.W.idx.shape == (R, N, K)
    assert plan.c.shape == (R,) and plan.m_scale.shape == (R, N)
    dense = X.plan_dynamic(proto, chans, "cpu",
                           torch.stack([sw[r].dense() for r in range(R)]))
    for f in ("c", "amp", "sigma_m", "m_scale", "listen"):
        np.testing.assert_allclose(getattr(plan, f).numpy(),
                                   np.asarray(getattr(rplan, f)), rtol=1e-6,
                                   err_msg=f)
        assert torch.equal(getattr(plan, f), getattr(dense, f)), f
    for r in range(R):
        one = X.plan_dynamic_sparse(proto, dataclasses.replace(
            chans, **{f: getattr(chans, f)[r] for f in FIELDS}), "cpu", sw[r])
        for f in ("m_scale", "listen", "amp"):
            assert torch.equal(getattr(plan, f)[r], getattr(one, f)), f


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_plain_sparse_round_over_r_is_r_single_rounds(noisy):
    """[R, N, d] at N = 13 (each replicate padded to 16 on its own)."""
    gen = torch.Generator().manual_seed(2)
    n, d = 13, 300
    pos = torch.rand((R, n, 2), generator=gen) * 100.0
    sw = G.sparse_metropolis(G.GeometryConfig(area=100.0, comm_radius=40.0),
                             pos, K)
    p, g = (torch.randn((R, n, d), generator=gen) for _ in range(2))
    amp = torch.rand((R, n), generator=gen)
    c, sm = torch.rand(R, generator=gen) + 0.5, torch.rand(R, generator=gen)
    listen = (sw.off_degree() > 0).float()
    seeds = torch.tensor([5, -7, 2 ** 30], dtype=torch.int32)
    kw = dict(gamma=0.01, eta=0.4, noisy=noisy, col0=128)
    out = ops.dp_mix_round_sparse(p, g, seeds, sw, amp, c, sm, listen=listen,
                                  **kw)
    assert out.shape == (R, n, d)
    for r in range(R):
        one = ops.dp_mix_round_sparse(p[r], g[r], seeds[r], sw[r], amp[r],
                                      c[r], sm[r], listen=listen[r], **kw)
        assert torch.equal(out[r], one), r
    with pytest.raises(ValueError, match="neighbor list must be"):
        ops.dp_mix_round_sparse(p, g, seeds, sw[0], amp, c, sm, **kw)
    with pytest.raises(ValueError, match="exceeds 2"):
        ops.dp_mix_round_sparse(torch.zeros((2, 3, 8)), torch.zeros((2, 3, 8)),
                                seeds[:2], sw[:2, :3], amp[:2, :3], c[:2],
                                sm[:2], gamma=0.01, eta=0.4,
                                counter_width=1 << 30)


def _bodies(flat: bool, reps, n=N, seed=5, telemetry=None):
    """The single sparse network's round body (reps None) or the fleet's,
    each with its initial carry, from one generator seed."""
    proto = P.ProtocolConfig(**dict(KW, n_workers=n))
    store, _ = _store(n)
    g = torch.Generator().manual_seed(seed)
    cfg = _cfg()
    if reps is None:
        wp = P.init_worker_params(g, cfg, n, "cpu")
        spec = X.FlatSpec(wp) if flat else None
        sim = proto.simulator("cpu")
        body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim,
                                  telemetry=telemetry)
        net = sim.init(g)
    else:
        fleet = FleetEngine(proto, reps, device="cpu")
        wp = fleet.init_worker_params(g, cfg)
        spec = X.FlatSpec(wp, lead_axes=2) if flat else None
        body = TJ.make_round_body(cfg, proto, store, spec, "cpu", fleet=fleet,
                                  telemetry=telemetry)
        net = fleet.init(g)
    eps = (None if telemetry is None
           else tele.init_eps_moments(reps, device="cpu"))
    return body, TJ.TrajCarry(g, spec.flatten(wp) if flat else wp, net, eps)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
def test_one_replicate_is_the_single_sparse_round(flat):
    """At R = 1 the fleet draws what the single network draws, in the same
    order, and mixes through the same list: two rounds bitwise."""
    outs = []
    for reps in (None, 1):
        body, carry = _bodies(flat, reps)
        carry, out = TJ.run_chunk(body, carry, 2)
        params = (carry.params if flat else
                  X.FlatSpec(carry.params, 1 if reps is None else 2)
                  .flatten(carry.params))
        sw = out["W"]
        assert isinstance(sw, SparseW)
        outs.append((params.reshape(N, -1), sw.idx.reshape(2, N, K),
                     sw.w.reshape(2, N, K), sw.self_w.reshape(2, N),
                     out["metrics"]["loss"].reshape(2)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def ref_operands(ref_round):
    """The reference fleet's [R, N, ...] parameters (the flat and tree
    rounds start from them), its batch and step keys, and the port's
    replay of the batch and of the parameters as a tree."""
    import jax
    from repro.configs.dwfl_paper import CONFIG as REF_CFG
    from repro.data import device as rdevice
    rfleet = ref_round[1]
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    store, (x, y, parts) = _store()
    rstore = rdevice.ClassificationStore.build(x, y, parts, B)
    k_data, k_step = jax.random.split(jax.random.PRNGKey(11))
    u = torch.from_numpy(np.stack([
        np.array(jax.random.uniform(k, (N, B)))
        for k in jax.random.split(k_data, R)]))
    rwp = jax.jit(rfleet.init_worker_params, static_argnums=1)(
        jax.random.PRNGKey(2), rcfg)
    wp = X.tree_map(t, jax.tree_util.tree_map(np.asarray, rwp))
    return (rcfg, rwp, rstore.sample_fleet(k_data, R),
            rfleet.split_keys(k_step), wp, store.sample_fleet(u))


def test_fleet_sparse_flat_round_equals_the_reference_s(ref_round,
                                                         ref_operands):
    import jax
    from repro.core import exchange as RX
    from repro_torch.convert import fleet_params_from_jax
    _, rfleet, _, rchans, _, rWs = ref_round
    rcfg, rwp, rbatch, keys, _, batch = ref_operands
    rspec = RX.make_flat_spec(rwp, lead_axes=2)
    rstep = jax.jit(rfleet.make_fleet_step(rcfg, flat=True, spec=rspec))
    rout, rm = rstep(rspec.flatten(rwp), rbatch, keys, rchans, rWs)
    flat, _, spec = fleet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, rwp), device="cpu")
    seeds = torch.cat([ops.seed_from_key(np.asarray(jax.random.split(k)[0]))
                       .reshape(1) for k in keys])
    proto = P.ProtocolConfig(**KW, replicates=R)
    step = P.make_fleet_flat_train_step(_cfg(), proto, spec, "cpu")
    chans, sw = port_chan(rchans), port_sw(rWs)
    dense_before = ops.dp_mix_round.launches
    out, m = step(flat, batch, seeds, chans, sw)
    assert ops.dp_mix_round.launches == dense_before
    want = np.asarray(rout)
    plan = X.plan_dynamic_sparse(proto, chans, "cpu", sw)
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-6 * _scale(plan, want))
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(rm["loss"]),
                               rtol=1e-5)
    assert m["loss"].shape == (R,)


def test_fleet_sparse_tree_round_equals_the_reference_s(ref_round,
                                                         ref_operands):
    import jax
    import jax.numpy as jnp
    _, rfleet, _, rchans, _, rWs = ref_round
    rcfg, rwp, rbatch, keys, wp, _ = ref_operands
    rout, rm = jax.jit(rfleet.make_fleet_step(rcfg))(rwp, rbatch, keys,
                                                       rchans, rWs)
    shapes = [x.shape[1:] for x in jax.tree_util.tree_leaves(rwp)]

    @jax.jit
    def draw(key):
        # a replicate's dynamic tree round: its step key splits in two
        # ("n", "m"), each half per leaf
        return [[jax.random.normal(k, x, jnp.float32) for k, x in
                 zip(jax.random.split(half, len(shapes)), shapes)]
                for half in jax.random.split(key)]

    per = [draw(keys[r]) for r in range(R)]       # [R][half][leaf]
    _, structure = X.tree_flatten(wp)
    G_ = {f: X.tree_unflatten(structure, [
        torch.stack([t(per[r][i][j]) for r in range(R)])
        for j in range(len(shapes))]) for i, f in enumerate(("n", "m"))}
    batch = {k: t(v) for k, v in rbatch.items()}
    proto = P.ProtocolConfig(**KW, replicates=R)
    step = P.make_fleet_train_step(_cfg(), proto, "cpu")
    chans, sw = port_chan(rchans), port_sw(rWs)
    out, m = step(wp, batch, None, chans, sw, normals=G_)
    got = X.FlatSpec(out, 2).flatten(out).numpy()
    want = np.concatenate([np.asarray(l).reshape(R, N, -1) for l in
                           jax.tree_util.tree_leaves(rout)], axis=-1)
    plan = X.plan_dynamic_sparse(proto, chans, "cpu", sw)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * _scale(plan, want))
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(rm["loss"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# stacked lists: the fleet's log, its privacy report and telemetry
# ---------------------------------------------------------------------------


def test_stack_rounds_and_epsilon_report_on_stacked_lists():
    import jax
    from repro.core import protocol as RP
    from repro.fleet import engine as rengine
    T = 5
    rproto = RP.ProtocolConfig(**KW, replicates=R, accountant="rdp")
    rchans, _, rWs = jax.jit(rengine.FleetEngine(rproto).trajectory,
                             static_argnums=1)(jax.random.PRNGKey(7), T)
    proto = P.ProtocolConfig(**KW, replicates=R, accountant="rdp")
    chans, sw = port_chan(rchans), port_sw(rWs)
    assert sw.idx.shape == (R, T, N, K)
    rep = fleet_epsilon_report(proto, chans, sw)
    rrep = rengine.fleet_epsilon_report(rproto, rchans, rWs)
    assert set(rep) == set(rrep)
    for k, v in rrep.items():
        if isinstance(v, (str, bool, int)):
            assert rep[k] == v, k
        else:
            np.testing.assert_allclose(rep[k], v, rtol=2e-6, err_msg=k)
    dense = torch.stack([torch.stack([sw[r, i].dense() for i in range(T)])
                         for r in range(R)])
    rep_d = fleet_epsilon_report(proto, chans, dense)
    for k in ("epsilon_per_round", "epsilon_composed_per_replicate",
              "epsilon_rdp_per_replicate"):
        np.testing.assert_allclose(rep[k], rep_d[k], rtol=1e-5, err_msg=k)
    tel = fleet_round_telemetry(proto, chans, sw)
    rtel = rengine.fleet_round_telemetry(rproto, rchans, rWs)
    assert tel["participation"].shape == (R, T)
    for k in ("deep_fade", "participation"):
        np.testing.assert_array_equal(tel[k].numpy(), np.asarray(rtel[k]))
    for k in ("snr_db", "epsilon"):
        np.testing.assert_allclose(tel[k].numpy(), np.asarray(rtel[k]),
                                   rtol=1e-5, err_msg=k)
    # the port's own log: rounds stacked on axis 1, replicate-major
    fleet = FleetEngine(proto, device="cpu")
    gen = torch.Generator().manual_seed(1)
    st = fleet.init(gen)
    rounds = []
    for _ in range(3):
        st, _, _, W = fleet.round(gen, st)
        rounds.append(W)
    log = stack_rounds(rounds)
    assert isinstance(log, SparseW) and log.idx.shape == (R, 3, N, K)
    for i, W in enumerate(rounds):
        assert torch.equal(log.idx[:, i], W.idx)
        assert torch.equal(log.self_w[:, i], W.self_w)
    major = TJ.replicate_major(SparseW(*(torch.stack(
        [getattr(W, f) for W in rounds]) for f in ("idx", "w", "self_w"))))
    for f in ("idx", "w", "self_w"):
        assert torch.equal(getattr(major, f), getattr(log, f))


def test_fleet_sparse_telemetry_leaves_the_trajectory_bitwise():
    """Telemetry on a fleet sparse body: the buffer bitwise the run
    without it, its channel columns those ``fleet_round_telemetry``
    computes from the logged lists, bitwise."""
    finals = []
    proto = P.ProtocolConfig(**dict(KW, n_workers=8))
    for spec_t in (None, tele.TelemetrySpec()):
        body, carry = _bodies(True, R, n=8, telemetry=spec_t)
        carry, out = TJ.run_chunk(body, carry, 2)
        finals.append(carry.params)
        if spec_t is not None:
            assert out["telemetry"].shape == (2, R, 7)
            cols = spec_t.unpack(out["telemetry"])
            ref = fleet_round_telemetry(proto, *(TJ.replicate_major(out[k])
                                                 for k in ("chan", "W")))
            for k, v in ref.items():
                torch.testing.assert_close(cols[k], v.transpose(0, 1),
                                           rtol=0, atol=0, equal_nan=True)
            assert carry.eps[:, 3].tolist() == [2.0] * R
    assert torch.equal(finals[0], finals[1])


def test_no_n_by_n_tensor_in_a_fleet_sparse_round():
    """A whole fleet sparse flat round at R = 2, N = 32 (graph_block 8: the
    stacked simulator round, the plans, the gradients, the mix, the
    metrics) makes no tensor with two axes of N; its graph build's largest
    transient is [R, 8, N]."""
    from test_torch_sparse import _Shapes
    n = 32
    proto = P.ProtocolConfig(**dict(KW, n_workers=n, sparse_neighbors=12,
                                    scenario="mesh_sparse"))
    fleet = FleetEngine(proto, 2, device="cpu")
    fleet.sim.graph_block = 8
    store, _ = _store(n)
    g = torch.Generator().manual_seed(1)
    wp = fleet.init_worker_params(g, _cfg())
    spec = X.FlatSpec(wp, lead_axes=2)
    body = TJ.make_round_body(_cfg(), proto, store, spec, "cpu", fleet=fleet)
    carry = TJ.TrajCarry(g, spec.flatten(wp), fleet.init(g))
    with _Shapes() as watch:
        carry, out = body(carry)
    nn = [s for s in watch.shapes if sum(a == n for a in s) >= 2]
    assert not nn, nn
    assert (2, 8, n) in watch.shapes
    assert out["W"].idx.shape == (2, n, 12)


@pytest.mark.parametrize("extra", [["--flat-buffer", "--telemetry", "on"],
                                   []], ids=["flat", "tree"])
def test_cli_fleet_sparse_on_cpu(extra, tmp_path):
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    res = train.run(["--device", "cpu", "--hidden", "16", "--workers", "16",
                     "--steps", "2", "--dataset-size", "2000",
                     "--channel-model", "dynamic", "--scenario",
                     "mesh_sparse", "--replicates", "2",
                     "--sparse-neighbors", "4", "--eval-every", "2",
                     "--checkpoint", ck, *extra])
    assert res["losses"].shape == (3, 2)
    rep = res["epsilon_report"]
    assert (rep["replicates"], rep["rounds"]) == (2, 3)
    assert np.isfinite(rep["epsilon_per_round"]).all()
    import json
    meta = json.load(open(ck + ".json"))["metadata"]
    assert meta["sparse_neighbors"] == 4
    assert meta["sparse_w"] == {"format": "padded-neighbor-v1",
                                "n_workers": 16, "k": 4,
                                "pad": "self-index-zero-weight"}
    if "--flat-buffer" in extra:
        assert res["params"].shape[:2] == (2, 16)
        assert res["telemetry"].shape == (3, 2, 7)


def test_cli_fleet_sparse_model_shards_is_bitwise_the_unsharded_run():
    """--model-shards 2 with --replicates and --sparse-neighbors (the
    reference's CLI runs them together): the logical mode's 2 column
    windows bitwise the unsharded fleet, buffer and losses."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--hidden", "16", "--workers", "16",
            "--steps", "2", "--dataset-size", "2000", "--flat-buffer",
            "--channel-model", "dynamic", "--scenario", "iot_dense",
            "--replicates", "2", "--sparse-neighbors", "4",
            "--eval-every", "0"]
    base = train.run(argv)
    got = train.run(argv + ["--model-shards", "2"])
    d = base["params"].shape[-1]
    assert got["params"].shape[-1] > d
    assert torch.equal(got["params"][..., :d], base["params"])
    assert torch.equal(got["losses"], base["losses"])


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("reps,n,d,k", [(3, 10, 5000, 4), (4, 130, 3001, 12),
                                        (2, 64, 70001, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noisy", [True, False], ids=["noisy", "gossip"])
def test_sparse_replicate_axis_is_r_separate_launches(reps, n, d, k, dtype,
                                                      noisy):
    """One prep and one gather launch (one count) for R sparse rounds, each
    replicate bitwise its own launch and within the plain twin's
    tolerance: (k + 9) 2^-23 scale, scale = max|x| + 5.42 (max|amp/c| +
    max|m_scale sigma_m|), a bfloat16 output one bfloat16 step further."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(n + d)
    pos = torch.rand((reps, n, 2), generator=gen, device=dev) * 100.0
    pos[:, 0] = 1e4                                  # one isolated worker
    radius = 100.0 * (8.0 / (3.14159 * n)) ** 0.5
    sw = G.sparse_metropolis(G.GeometryConfig(area=100.0,
                                              comm_radius=radius), pos, k,
                             block=max(1, n // 3))
    p = torch.randn((reps, n, d), generator=gen, device=dev).to(dtype)
    g = (0.2 * torch.randn((reps, n, d), generator=gen,
                           device=dev)).to(dtype)
    amp = torch.rand((reps, n), generator=gen, device=dev) + 0.5
    mscale = 0.3 * torch.rand((reps, n), generator=gen, device=dev)
    c = torch.rand(reps, generator=gen, device=dev) + 1.5
    sm = torch.full((reps,), 0.3, device=dev)
    listen = (sw.off_degree() > 0).float()
    seeds = torch.arange(reps, dtype=torch.int32, device=dev) * 7919 - 5
    kw = dict(gamma=0.05, eta=0.4, noisy=noisy, col0=256,
              counter_width=80000)
    before = ops.dp_mix_round_sparse.launches
    out = ops.dp_mix_round_sparse(p, g, seeds, sw, amp, c, sm,
                                  m_scale=mscale, listen=listen, **kw)
    assert ops.dp_mix_round_sparse.launches == before + 1
    for r in range(reps):
        one = ops.dp_mix_round_sparse(p[r], g[r], seeds[r], sw[r], amp[r],
                                      c[r], sm[r], m_scale=mscale[r],
                                      listen=listen[r], **kw)
        assert torch.equal(out[r], one), r
        vecs = ops._round_vectors(n, dev, seeds[r], 256, amp[r], c[r], sm[r],
                                  None, mscale[r], listen[r])
        ref = dp_mix_sparse_plain(p[r], g[r], *vecs, sw.idx[r], sw.w[r],
                                  sw.self_w[r], gamma=0.05, eta=0.4,
                                  noisy=noisy, counter_width=80000)
        k32, r32 = out[r].float(), ref.float()
        x = p[r].float() - 0.05 * g[r].float()
        scale = float(x.abs().max())
        if noisy:
            scale += 5.42 * float((amp[r] / c[r]).abs().max()
                                  + (mscale[r] * sm[r]).abs().max())
        allowed = (k + 1 + 8) * 2.0 ** -23 * scale
        if dtype == torch.bfloat16:
            allowed = allowed + 2.0 ** -7 * torch.maximum(k32.abs(),
                                                          r32.abs())
        assert bool(((k32 - r32).abs() <= allowed).all()), r
    torch.cuda.synchronize()
