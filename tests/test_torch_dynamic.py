"""The dynamic DWFL round on the port (ROADMAP A9): the plan, the flat and
the worker-tree step, the trajectory and the CLI, against the reference on
the CPU.

A round is replayed from the reference's realized operands: its channel
and W from ``NetworkSimulator.round`` (iot_dense, with churned-out and
radio-isolated workers), its parameters and batch, and its noise — the
int32 seed of the fused flat round (``seed_from_key(k_n)``), or the
reference's ``jax.random`` normals of the tree round. Tolerance as
tests/test_torch_exchange.py defines it: both packages compute in float32
and differ in the order of the N-term mix, atol = 1e-6 * scale with scale
= 1 + max|x| + 5.42 max|amp/c|. The plan (``plan_dynamic``) is float32
from the same W and channel: rtol 1e-6. The dynamic ``epsilon_report``
from the same stacked channels and Ws has the reference's keys; its
per-round budgets are float32 (rtol 1e-6) and their float64 compositions
inherit that (rtol 2e-6).

The port's own generator draws are checked for chunking: a dynamic
trajectory is bitwise the same however its rounds are cut into chunks.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import exchange as RX
from repro.core import protocol as RP
from repro_torch.configs import DWFL_PAPER
from repro_torch.convert import params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, classification_dataset,
                              dirichlet_partition)
from repro_torch.kernels.dp_mix import ops
from repro_torch.kernels.dp_perturb import ops as dp_ops
from repro_torch.net.state import TracedChannelState
from test_torch_net import port_chan, ref_round, t
from test_torch_protocol import _batch, _port_flat, _tree

ROOT = Path(__file__).resolve().parents[1]
N, B, HIDDEN = 6, 8, 16
KW = dict(scheme="dwfl", n_workers=N, gamma=0.01, eta=0.4, clip=1.0,
          target_epsilon=0.0, sigma=0.5, channel_model="dynamic",
          scenario="iot_dense")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net_round():
    """A realized iot_dense round of the reference with sigma 0.5: a
    worker churned out and others isolated by the radio range."""
    _, _, rchan, rmask, rW = ref_round("iot_dense", N, 7, rounds=4,
                                       sigma=0.5, sigma_m=0.3, p_dbm=30.0)
    off = (np.asarray(rW) > 0) & ~np.eye(N, dtype=bool)
    assert (off.sum(1) == 0).any() and (off.sum(1) > 0).sum() >= 2
    return rchan, rW


def _scale(plan, x):
    return 1.0 + float(np.abs(x).max()) + 5.42 * float(
        (plan.amp / plan.c).abs().max())


def test_dynamic_plan_equals_reference(net_round):
    rchan, rW = net_round
    proto, rproto = P.ProtocolConfig(**KW), RP.ProtocolConfig(**KW)
    plan = X.plan_dynamic(proto, port_chan(rchan), "cpu", t(rW))
    rplan = RX.plan_dynamic(rproto, rchan, W_arg=rW)
    for f in ("W", "c", "amp", "sigma_m", "m_scale", "listen"):
        np.testing.assert_allclose(np.asarray(getattr(plan, f)),
                                   np.asarray(getattr(rplan, f)), rtol=1e-6,
                                   err_msg=f)
    assert plan.self_scale is None and rplan.self_scale is None
    assert (plan.listen == 0).any()
    with pytest.raises(ValueError, match="mixing matrix"):
        X.plan_dynamic(proto, port_chan(rchan), "cpu")


def _flat_both(seed=0):
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    wp = RP.init_worker_params(jax.random.PRNGKey(seed), rcfg, N)
    rspec = RX.FlatSpec(wp)
    rstep = jax.jit(RP.make_dynamic_flat_train_step(
        rcfg, RP.ProtocolConfig(**KW), rspec.unravel_row))
    flat, _, spec = params_from_jax(jax.tree_util.tree_map(np.asarray, wp),
                                    device="cpu")
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    step = P.make_dynamic_flat_train_step(cfg, P.ProtocolConfig(**KW), spec,
                                          "cpu")
    x, y = classification_dataset(400, seed=seed)
    parts = dirichlet_partition(y, N, seed=seed)
    from repro.data import device as ref_device
    rstore = ref_device.ClassificationStore.build(x, y, parts, B)
    store = ClassificationStore.build(x, y, parts, B, device="cpu")
    return rstep, rspec.flatten(wp), rstore, step, flat, store, spec


def test_one_dynamic_flat_round_matches_reference(net_round):
    rchan, rW = net_round
    rstep, rflat, rstore, step, flat, store, spec = _flat_both()
    key = jax.random.PRNGKey(11)
    k_data, k_step = jax.random.split(key)
    rout, rm = rstep(rflat, rstore.sample(k_data), k_step, rchan, rW)
    u = torch.from_numpy(np.array(jax.random.uniform(k_data, (N, B))))
    seed = ops.seed_from_key(np.asarray(jax.random.split(k_step)[0]))
    chan = port_chan(rchan)
    before = ops.dp_mix_round.launches
    out, m = step(flat, store.sample(u), seed, chan, t(rW))
    assert ops.dp_mix_round.launches == before      # the CPU's plain twin
    want = np.asarray(rout)
    plan = X.plan_dynamic(None, chan, "cpu", t(rW))
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-6 * _scale(plan, want))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    # a worker with no neighbor takes its local step alone: p - gamma g
    idle = (plan.listen == 0).numpy()
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    g = P.make_flat_local_pass(cfg, P.ProtocolConfig(**KW), spec)(
        flat, store.sample(u))[1]
    np.testing.assert_array_equal(out.numpy()[idle],
                                  (flat - 0.01 * g).numpy()[idle])


def _template(cfg):
    return P.init_worker_params(torch.Generator().manual_seed(0), cfg, N,
                                "cpu")


def _dynamic_normals(X_ref, key):
    """The reference dynamic tree round's realized normals ({"n", "m"}):
    its step key splits in two, each half per leaf."""
    k_n, k_m = jax.random.split(key)
    leaves, treedef = jax.tree_util.tree_flatten(X_ref)

    def per_leaf(k):
        keys = jax.random.split(k, len(leaves))
        return jax.tree_util.tree_unflatten(treedef, [
            torch.from_numpy(np.array(jax.random.normal(kk, x.shape,
                                                        jnp.float32)))
            for kk, x in zip(keys, leaves)])

    return {"n": per_leaf(k_n), "m": per_leaf(k_m)}


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "pallas"])
def test_one_dynamic_tree_round_matches_reference(net_round, use_pallas):
    rchan, rW = net_round
    kw = dict(KW, use_pallas=use_pallas)
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    rwp = RP.init_worker_params(jax.random.PRNGKey(1), rcfg, N)
    rstep = jax.jit(RP.make_dynamic_train_step(rcfg, RP.ProtocolConfig(**kw)))
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    step = P.make_dynamic_train_step(cfg, P.ProtocolConfig(**kw), "cpu")
    from repro_torch.data import FederatedBatcher
    x, y = classification_dataset(400, seed=1)
    batcher = FederatedBatcher(x, y, dirichlet_partition(y, N, seed=1), B,
                               seed=1)
    rb, tb = _batch(batcher)
    key = jax.random.PRNGKey(3)
    rout, rm = rstep(rwp, rb, key, rchan, rW)
    before = dp_ops.sgd_update_leaves.launches
    out, m = step(_tree(rwp), tb, None, port_chan(rchan), t(rW),
                  normals=_dynamic_normals(rwp, key))
    assert dp_ops.sgd_update_leaves.launches == before
    want = np.concatenate([np.asarray(l).reshape(N, -1)
                           for l in jax.tree_util.tree_leaves(rout)], axis=1)
    got = _port_flat(out)
    plan = X.plan_dynamic(None, port_chan(rchan), "cpu", t(rW))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * _scale(plan, want))
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)


def test_dynamic_round_on_a_static_channel_is_the_static_round():
    """The dynamic flat step given the static channel (as a traced state)
    and the complete W is the static flat step's round."""
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    static = P.ProtocolConfig(**dict(KW, channel_model="static"))
    wp = _template(cfg)
    spec = X.FlatSpec(wp)
    x, y = classification_dataset(400, seed=2)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, N, seed=2),
                                      B, device="cpu")
    batch = store.draw(torch.Generator().manual_seed(1))
    want, _ = P.make_flat_train_step(cfg, static, spec, "cpu")(
        spec.flatten(wp), batch, 17)
    chan = TracedChannelState.from_static(static.channel(), "cpu")
    W = X.masked_complete_W(torch.ones(N, dtype=torch.bool))
    got, _ = P.make_dynamic_flat_train_step(cfg, P.ProtocolConfig(**KW), spec,
                                            "cpu")(spec.flatten(wp), batch,
                                                   17, chan, W)
    plan = X.plan_dynamic(None, chan, "cpu", W)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * _scale(plan, want.numpy()))


def test_dynamic_epsilon_report_equals_reference():
    """From the same stacked channels and Ws (a reference trajectory with
    per-round calibration): the reference's keys, per-round budgets within
    rtol 1e-6, compositions within 2e-6."""
    rsim, rst, _, _, _ = ref_round("vehicular", 8, 2, p_dbm=65.0,
                                   target_epsilon=0.7, gamma=0.05)
    rchans, _, rWs = rsim.trajectory(jax.random.PRNGKey(9), 16, rst)
    kw = dict(scheme="dwfl", n_workers=8, gamma=0.05, clip=1.0,
              channel_model="dynamic", scenario="vehicular",
              accountant="rdp")
    rep = P.epsilon_report(P.ProtocolConfig(**kw), port_chan(rchans),
                           Ws=t(rWs))
    rrep = RP.epsilon_report(RP.ProtocolConfig(**kw), rchans, Ws=rWs)
    assert set(rep) == set(rrep)
    for k, v in rrep.items():
        if isinstance(v, (str, bool, int)) or k == "rdp_order":
            assert rep[k] == v, k
        else:
            np.testing.assert_allclose(rep[k], v, rtol=2e-6, err_msg=k)
    assert rep["epsilon_worst"] <= 0.7 * (1 + 1e-5)


def _dynamic_body(flat: bool, seed=2):
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    proto = P.ProtocolConfig(**dict(KW, scenario="vehicular"))
    wp = P.init_worker_params(torch.Generator().manual_seed(seed), cfg, N,
                              "cpu")
    spec = X.FlatSpec(wp) if flat else None
    x, y = classification_dataset(400, seed=seed)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, N,
                                                                seed=seed),
                                      B, device="cpu")
    sim = proto.simulator("cpu")
    body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim)
    g = torch.Generator().manual_seed(9)
    return body, TJ.TrajCarry(g, spec.flatten(wp) if flat else wp,
                              sim.init(g))


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
def test_dynamic_trajectory_chunks_do_not_change_the_stream(flat):
    """5 rounds as 2+3 or 1+1+3 give the same parameters, network state,
    channels and Ws as 5 in one chunk."""
    finals = []
    for parts in ((5,), (2, 3), (1, 1, 3)):
        body, carry = _dynamic_body(flat)
        outs = []
        for k in parts:
            carry, out = TJ.run_chunk(body, carry, k)
            outs.append(out)
        traj = TJ.concat_chunks(outs)
        assert traj["W"].shape == (5, N, N) and traj["chan"].c.shape == (5,)
        params = carry.params if flat else X.flatten_worker_tree(carry.params)
        finals.append((params, carry.net.geometry.pos, traj["chan"].h,
                       traj["W"]))
    for f in finals[1:]:
        for a, b in zip(f, finals[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_per_round_executor_equals_chunks_on_the_dynamic_path():
    body, carry = _dynamic_body(True, seed=3)
    c1, o1 = TJ.run_chunk(body, carry, 3)
    body, carry = _dynamic_body(True, seed=3)
    c2, o2 = TJ.run_per_round(body, carry, 3)
    torch.testing.assert_close(c1.params, c2.params, rtol=0, atol=0)
    torch.testing.assert_close(o1["W"], o2["W"], rtol=0, atol=0)
    assert o2["metrics"]["loss"].device.type == "cpu"


def test_dynamic_steps_refuse_other_schemes():
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    with pytest.raises(ValueError, match="scheme='dwfl'"):
        P.make_dynamic_train_step(cfg, P.ProtocolConfig(
            **dict(KW, scheme="orthogonal")), "cpu")
    # sparse_neighbors takes the neighbor-list route (ROADMAP A10)
    sparse = P.ProtocolConfig(**dict(KW, sparse_neighbors=4))
    P.make_dynamic_train_step(cfg, sparse, "cpu")
    assert X.resolve_spec(sparse, dynamic=True).name == "dynamic_sparse"
    with pytest.raises(ValueError, match="scheme='dwfl'"):
        P.make_dynamic_train_step(cfg, P.ProtocolConfig(
            **dict(KW, scheme="gossip", sparse_neighbors=4)), "cpu")
    with pytest.raises(ValueError, match="channel_model='dynamic'"):
        P.ProtocolConfig(n_workers=N).simulator("cpu")


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--hidden", "16", "--workers", "4", "--steps", "3",
         "--dataset-size", "2000", "--channel-model", "dynamic",
         "--scenario", "iot_dense", *argv],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)


@pytest.mark.parametrize("argv", [["--flat-buffer"], [],
                                  ["--flat-buffer", "--total-epsilon", "4",
                                   "--accountant", "rdp"]],
                         ids=["flat", "tree", "total-rdp"])
def test_dynamic_cli_runs_on_cpu(argv):
    r = _cli(*argv)
    assert r.returncode == 0, r.stderr
    assert ("[train] dwfl-paper scheme=dwfl N=4 dynamic scenario=iot_dense "
            "coherence=20 rounds") in r.stdout
    assert "[train] per-round eps over 4 rounds: min=" in r.stdout
    assert "[train] accountant[" in r.stdout and "-> quoting" in r.stdout
    if "--total-epsilon" in argv:
        assert ("[train] total budget: eps=4.0 delta=1e-05 over 4 rounds "
                "(accountant=rdp)") in r.stdout
        assert "[train] accountant[rdp]:" in r.stdout


def test_total_epsilon_needs_the_dynamic_channel():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="requires --channel-model dynamic"):
        train.parse_args(["--total-epsilon", "4"])
