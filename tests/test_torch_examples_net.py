"""The port's network examples (``examples/port_dynamic_quickstart.py``,
``examples/port_fleet_quickstart.py``) against the reference on the CPU,
and the round guards that stand for the reference's "traced exactly
once" asserts.

Each loop runs three rounds on the reference's realized operands: the
same numpy batches, the simulator's channels, masks and Ws (one network,
or R stacked), and the tree round's ``jax.random`` normals, beside the
reference's jitted steps. Tolerances as tests/test_torch_examples.py
states them: parameters within 3e-6 (1 + max|x| + 5.42 max|amp/c|)
after three rounds (measured at most 2.4e-8 of it), losses rtol 1e-5,
the trajectory's per-round budgets rtol 1e-6 and their float64
compositions rtol 2e-6; the fleet's eval mean within rtol 1e-5 and its
CI at rtol 1e-3 (a difference of float32 means over 8 replicates).

The guards (``obs.guard.RoundGuards``) are shown to fail on what they
guard: a host read inside the round, a kernel build after round 0, and a
round whose work changes — on stand-in rounds through both examples'
loops, and on the dynamic example's own round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import protocol as RP
from repro.data import FederatedBatcher as RefBatcher
from repro.fleet import engine as rengine
import repro.models.mlp as ref_mlp
from repro.net.state import stack_states as ref_stack_states
from repro_torch.convert import fleet_params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.kernels import build
from repro_torch.obs.guard import HostReadError, RetraceError, RoundGuards
from test_torch_dynamic import _dynamic_normals
from test_torch_examples import (ROUNDS, TREE_TOL, _down, _scale, _tree,
                                 _up, example)
from test_torch_net import port_chan, t


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- port_dynamic_quickstart.py: the dynamic tree round under the guards -------


def _ref_dynamic(ex, rounds=ROUNDS):
    """The reference's dynamic quickstart for ``rounds`` rounds, and its
    realized operands: [(batch, chan, mask, W, normals)]."""
    kw = ex.PROTO
    rproto = RP.ProtocolConfig(**kw)
    sim = rproto.simulator()
    x, y = ex.classification_dataset(6000, input_dim=ex.INPUT_DIM, seed=0)
    rbatcher = RefBatcher(x, y, ex.dirichlet_partition(y, ex.N, alpha=0.5,
                                                       seed=0), ex.BATCH)
    rcfg = REF_CFG.replace(d_model=ex.HIDDEN)
    params = ref_mlp.init(jax.random.PRNGKey(0), rcfg, input_dim=ex.INPUT_DIM)
    rwp = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (ex.N,) + a.shape), params)
    wp0 = rwp
    rstep = jax.jit(RP.make_dynamic_train_step(rcfg, rproto))
    key = jax.random.PRNGKey(1)
    net_round = jax.jit(sim.round)
    key, nk = jax.random.split(key)
    state = sim.init(nk)
    ops_, chans, Ws, losses = [], [], [], []
    for _ in range(rounds):
        key, sk, ck = jax.random.split(key, 3)
        state, chan, mask, W = net_round(ck, state)
        b = rbatcher.next()
        ops_.append((_up(b), port_chan(chan), t(mask), t(W),
                     _dynamic_normals(rwp, sk)))
        rwp, rm = rstep(rwp, _down(b), sk, chan, W)
        chans.append(chan)
        Ws.append(W)
        losses.append(float(rm["loss"]))
    rep = RP.epsilon_report(rproto, ref_stack_states(chans),
                            Ws=jnp.stack(Ws))
    return rcfg, wp0, rwp, ops_, losses, rep, rbatcher.full(128)


def _replayed_round(step, operands):
    """A round_fn that replays the reference's realized round."""
    it = iter(operands)

    def round_fn(wp, batch):
        _, chan, mask, W, normals = next(it)
        wp, metrics = step(wp, batch, None, chan, W, normals=normals)
        return wp, metrics, chan, mask, W

    return round_fn


def test_dynamic_loop_replays_the_reference_under_the_guards():
    ex = example("port_dynamic_quickstart")
    rcfg, wp0, rwp, operands, rlosses, rrep, ev = _ref_dynamic(ex)
    proto = P.ProtocolConfig(**ex.PROTO)
    cfg = ex.DWFL_PAPER.replace(d_model=ex.HIDDEN)
    step = P.make_dynamic_train_step(cfg, proto, "cpu")
    guards = RoundGuards("cpu", label="test")
    seen = []
    wp, chans, Ws = ex.train(
        _replayed_round(step, operands), P.make_eval_fn(cfg), _tree(wp0),
        iter([o[0] for o in operands]), _up(ev), ROUNDS, eval_every=1,
        guards=guards, on_eval=lambda t_, m, *rest: seen.append(
            float(m["loss"])))
    assert guards.rounds == ROUNDS and guards.ops > 0
    assert seen == pytest.approx(rlosses, rel=1e-5)
    got = X.flatten_worker_tree(wp).numpy()
    want = np.concatenate([np.asarray(l).reshape(ex.N, -1)
                           for l in jax.tree_util.tree_leaves(rwp)], axis=1)
    plan = X.plan_dynamic(proto, chans[-1], "cpu", Ws[-1])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TREE_TOL * _scale(plan, want))
    rep = ex.trajectory_report(proto, chans, Ws)
    np.testing.assert_allclose(rep["epsilon_per_round"],
                               np.asarray(rrep["epsilon_per_round"]),
                               rtol=1e-6)
    for k in ("epsilon_trajectory_composed", "delta_trajectory_composed",
              "epsilon_mean", "epsilon_worst"):
        assert rep[k] == pytest.approx(float(rrep[k]), rel=2e-6), k
    assert rep["rounds"] == rrep["rounds"] == ROUNDS


def test_dynamic_main_on_the_cpu(capsys):
    ex = example("port_dynamic_quickstart")
    res = ex.main(["--device", "cpu", "--rounds", "3"])
    assert res["guarded_rounds"] == 3 and res["ops_per_round"] > 100
    assert res["rounds"] == 3 and [e["round"] for e in res["evals"]] == [0]
    row = res["evals"][0]
    assert 0 <= row["active"] <= ex.N and row["c"] > 0
    assert res["epsilon_max"] == pytest.approx(1.0, rel=1e-4)
    out = capsys.readouterr().out
    assert "per-round eps over 3 rounds" in out
    assert f"guarded rounds: 3 of 3, each {res['ops_per_round']}" in out


# -- the guards fail on what they guard ---------------------------------------


def _tiny_round(extra=None):
    """A stand-in round: a few device ops, then ``extra(t)``."""
    state = {"t": 0}

    def round_fn(wp, batch):
        wp = wp + batch
        metrics = {"loss": wp.sum()}
        if extra is not None:
            extra(state["t"], metrics)
        state["t"] += 1
        return wp, metrics, None, None, None

    return round_fn


def _run_dynamic(round_fn, rounds=3):
    ex = example("port_dynamic_quickstart")
    ones = iter([torch.ones(3)] * rounds)
    return ex.train(round_fn, None, torch.zeros(3), ones, None, rounds,
                    eval_every=rounds + 1, guards=RoundGuards("cpu"))


def _run_fleet(round_fn, rounds=3):
    ex = example("port_fleet_quickstart")
    ones = iter([torch.ones(3)] * rounds)
    fleet_round = lambda g, s, wp, b: (s,) + round_fn(wp, b)[:2] + (None,
                                                                   None)
    return ex.train(fleet_round, None, None, torch.zeros(3), ones, rounds,
                    eval_every=rounds + 1, guards=RoundGuards("cpu"))


@pytest.mark.parametrize("run", [_run_dynamic, _run_fleet],
                         ids=["dynamic", "fleet"])
def test_round_guards_refuse_a_host_read(run):
    run(_tiny_round())                                 # a clean round passes
    with pytest.raises(HostReadError, match="host read"):
        run(_tiny_round(lambda t_, m: float(m["loss"])))
    with pytest.raises(HostReadError, match="host read"):
        run(_tiny_round(lambda t_, m: m["loss"].item() if t_ == 2 else None))


@pytest.mark.parametrize("run", [_run_dynamic, _run_fleet],
                         ids=["dynamic", "fleet"])
def test_round_guards_refuse_a_build_after_round_0(run, monkeypatch):
    monkeypatch.setattr(build, "BUILDS", {})

    def builds(t_, m):
        build.BUILDS["dp_mix build"] = build.BUILDS.get("dp_mix build", 0) + 1

    with pytest.raises(RetraceError, match="round 1"):
        run(_tiny_round(builds))
    run(_tiny_round(lambda t_, m: builds(t_, m) if t_ == 0 else None))


@pytest.mark.parametrize("run", [_run_dynamic, _run_fleet],
                         ids=["dynamic", "fleet"])
def test_round_guards_refuse_a_round_whose_work_changes(run):
    with pytest.raises(RetraceError, match="round 2 dispatched"):
        run(_tiny_round(lambda t_, m: m["loss"] * 2 if t_ == 2 else None))


def test_dynamic_example_refuses_a_host_read_in_its_own_round():
    """The example's own round (the simulator, then the step) with a host
    read slipped into the step."""
    ex = example("port_dynamic_quickstart")
    proto, cfg, batcher, wp = ex.setup("cpu")
    sim = proto.simulator("cpu")
    gen = torch.Generator().manual_seed(1)
    step = P.make_dynamic_train_step(cfg, proto, "cpu")

    def leaky(*a, **k):
        out = step(*a, **k)
        float(out[1]["loss"])
        return out

    batches = iter([_up(batcher.next()) for _ in range(2)])
    with pytest.raises(HostReadError):
        ex.train(ex.network_round(leaky, sim, sim.init(gen), gen), None, wp,
                 batches, None, 2, guards=RoundGuards("cpu"))


# -- port_fleet_quickstart.py: R networks a round ------------------------------


def test_fleet_loop_replays_the_reference_s_stacked_rounds():
    ex = example("port_fleet_quickstart")
    R, N = 2, ex.N
    kw = dict(ex.PROTO, replicates=R)
    rproto = RP.ProtocolConfig(**kw)
    rfleet = rengine.FleetEngine(rproto)
    x, y = ex.classification_dataset(4000, input_dim=ex.INPUT_DIM, seed=0)
    parts = ex.dirichlet_partition(y, N, alpha=0.5, seed=0)
    rbatchers = [RefBatcher(x, y, parts, ex.BATCH, seed=r) for r in range(R)]
    rcfg = REF_CFG.replace(d_model=ex.HIDDEN)
    key = jax.random.PRNGKey(0)
    rwp = jax.vmap(lambda k: jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape),
        ref_mlp.init(k, rcfg, input_dim=ex.INPUT_DIM)))(
        jax.random.split(key, R))
    wp0 = jax.tree_util.tree_map(np.asarray, rwp)
    rstep = jax.jit(rfleet.make_fleet_step(rcfg))
    net_round = jax.jit(rfleet.round)
    key, nk = jax.random.split(key)
    states = rfleet.init(nk)
    operands, rchans, rWs, rlosses = [], [], [], []
    for _ in range(ROUNDS):
        key, k_net, k_step = jax.random.split(key, 3)
        states, chans, _, Ws = net_round(k_net, states)
        keys = rfleet.split_keys(k_step)
        draws = [b.next() for b in rbatchers]
        batch = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
        per = [_dynamic_normals(jax.tree_util.tree_map(lambda a: a[r], rwp),
                                keys[r]) for r in range(R)]
        normals = {f: X.tree_map(lambda *ls: torch.stack(ls),
                                 *[p[f] for p in per]) for f in ("n", "m")}
        operands.append((_up(batch), port_chan(chans), t(Ws), normals))
        rwp, rm = rstep(rwp, _down(batch), keys, chans, Ws)
        rchans.append(chans)
        rWs.append(Ws)
        rlosses.append(np.asarray(rm["loss"]))

    proto = P.ProtocolConfig(**kw)
    cfg = ex.DWFL_PAPER.replace(d_model=ex.HIDDEN)
    step = P.make_fleet_train_step(cfg, proto, "cpu")
    it = iter(operands)

    def fleet_round(generator, states_, wp, batch):
        _, chans, Ws, normals = next(it)
        wp, metrics = step(wp, batch, None, chans, Ws, normals=normals)
        return states_, wp, metrics, chans, Ws

    _, tree0, _ = fleet_params_from_jax(wp0, device="cpu")
    seen = []
    guards = RoundGuards("cpu", label="fleet test")
    _, wp, chans, Ws = ex.train(fleet_round, None, None, tree0,
                                iter([o[0] for o in operands]), ROUNDS,
                                eval_every=1, guards=guards,
                                on_round=lambda t_, m: seen.append(
                                    m["loss"].numpy()))
    assert guards.rounds == ROUNDS
    np.testing.assert_allclose(np.stack(seen), np.stack(rlosses), rtol=1e-5)
    got = X.FlatSpec(wp, 2).flatten(wp).numpy()
    want = np.concatenate([np.asarray(l).reshape(R, N, -1) for l in
                           jax.tree_util.tree_leaves(rwp)], axis=-1)
    plan = X.plan_dynamic(proto, chans[-1], "cpu", Ws[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=TREE_TOL * _scale(
        plan, want, plan.c[:, None]))

    full_np = rbatchers[0].full(256)
    full = {k: torch.from_numpy(v).expand((R,) + v.shape)
            for k, v in full_np.items()}
    out = ex.read_out(proto, P.make_eval_fn(cfg), wp, full, chans, Ws)
    rfull = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (R,) + a.shape), full_np)
    rl, ra = jax.vmap(RP.make_eval_fn(rcfg))(rwp, rfull)
    lm, lc = rengine.mean_ci(np.asarray(rl))
    am, ac = rengine.mean_ci(np.asarray(ra))
    assert out["loss_mean"] == pytest.approx(lm, rel=1e-5)
    assert out["loss_ci95"] == pytest.approx(lc, rel=1e-3, abs=1e-6)
    assert abs(out["acc_mean"] - am) <= 2 / (N * 256)
    rrep = rengine.fleet_epsilon_report(rproto,
                                        rengine.stack_rounds(rchans),
                                        rengine.stack_rounds(rWs))
    for k in ("epsilon_composed_mean", "epsilon_worst", "delta_composed"):
        assert out[k] == pytest.approx(float(rrep[k]), rel=2e-6), k
    assert out["epsilon_composed_ci95"] == pytest.approx(
        float(rrep["epsilon_composed_ci95"]), rel=1e-3, abs=1e-9)
    np.testing.assert_allclose(
        out["report"]["epsilon_per_round"],
        np.asarray(rrep["epsilon_per_round"]), rtol=1e-6)


def test_fleet_main_on_the_cpu(capsys):
    ex = example("port_fleet_quickstart")
    res = ex.main(["--device", "cpu", "--rounds", "2"])
    assert res["guarded_rounds"] == 2 and res["ops_per_round"] > 100
    assert len(res["evals"][0]["loss"]) == ex.R
    assert np.isfinite(res["loss_mean"]) and res["acc_ci95"] >= 0
    assert res["epsilon_worst"] == pytest.approx(1.0, rel=1e-4)
    out = capsys.readouterr().out
    assert f"after 2 rounds x {ex.R} replicates" in out
