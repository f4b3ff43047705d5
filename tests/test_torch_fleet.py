"""The fleet on the port (ROADMAP A12): R networks in one round, against
the reference's vmapped fleet on the CPU.

Each replicate of a fleet step is replayed from the reference's realized
operands: the stacked channels and Ws of ``FleetEngine.round``, the [R,
N, ...] parameters, the batch's uniforms of ``sample_fleet``, and each
replicate's noise (the int32 seed ``seed_from_key`` of its step key, or
its ``jax.random`` normals on the tree path). Tolerance as
tests/test_torch_dynamic.py states it: atol = 1e-6 * scale, scale = 1 +
max|x| + 5.42 max|amp/c| (float32 sums in another order). The batched
privacy functions are float32 of the same channels (rtol 1e-6) and their
float64 compositions inherit that (rtol 2e-6). At R = 1 the fleet's round
is bitwise the single network's from the same generator seed; the
port's own draws are otherwise checked for shape and independence.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import privacy as rprivacy
from repro.core import protocol as RP
from repro.data import device as rdevice
from repro.fleet import engine as rengine
from repro.fleet import sweep as rsweep
from repro_torch.configs import DWFL_PAPER
from repro_torch.convert import fleet_params_from_jax
from repro_torch.core import exchange as X
from repro_torch.core import privacy
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.core.channel import dbm_to_watts
from repro_torch.data import (ClassificationStore, classification_dataset,
                              dirichlet_partition)
from repro_torch.fleet import (FleetEngine, fleet_epsilon_report,
                               fleet_round_telemetry, mean_ci, stack_rounds)
from repro_torch.fleet import sweep
from repro_torch.kernels.dp_mix import ops
from repro_torch.kernels.dp_perturb import ops as dp_ops
from repro_torch.launch import train
from repro_torch.obs import telemetry as tele
from test_torch_dynamic import _dynamic_normals
from test_torch_net import port_chan, port_state, t

R, N, B, HIDDEN = 2, 4, 8, 16
KW = dict(scheme="dwfl", n_workers=N, gamma=0.01, eta=0.4, clip=1.0,
          target_epsilon=1.0, channel_model="dynamic", scenario="vehicular")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)


def _store(seed=1):
    x, y = classification_dataset(400, seed=seed)
    parts = dirichlet_partition(y, N, seed=seed)
    return (ClassificationStore.build(x, y, parts, B, device="cpu"),
            rdevice.ClassificationStore.build(x, y, parts, B))


def test_fleet_refuses_what_it_does_not_run():
    with pytest.raises(ValueError, match="channel_model='dynamic'"):
        FleetEngine(P.ProtocolConfig(n_workers=N), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="A20"):
        FleetEngine(P.ProtocolConfig(**dict(KW, scenario="mesh_sparse",
                                            sparse_neighbors=2)), 2,
                    device="cpu")
    fleet = FleetEngine(P.ProtocolConfig(**KW), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        fleet.init_flat_spec(torch.Generator(), _cfg(), n_shards=2)
    with pytest.raises(NotImplementedError, match="A14"):
        fleet.make_fleet_step(_cfg(), mesh=object())
    with pytest.raises(ValueError, match=">= 1"):
        FleetEngine(P.ProtocolConfig(**KW), 0, device="cpu")
    with pytest.raises(ValueError, match="entries"):
        FleetEngine(P.ProtocolConfig(**KW), 2, power_dbm=[60.0],
                    device="cpu")


def test_fleet_shapes():
    fleet = FleetEngine(P.ProtocolConfig(**KW), 3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    st = fleet.init(gen)
    assert st.geometry.pos.shape == (3, N, 2) and st.fading.t.shape == (3,)
    st, chans, masks, Ws = fleet.round(gen, st)
    assert chans.h.shape == (3, N) and chans.c.shape == (3,)
    assert chans.sigma.shape == (3,) and masks.shape == (3, N)
    assert Ws.shape == (3, N, N)
    chans, masks, Ws = fleet.trajectory(gen, 5, st)
    assert chans.h.shape == (3, 5, N) and Ws.shape == (3, 5, N, N)
    assert masks.shape == (3, 5, N)
    # replicates are independent draws, not copies
    assert not torch.equal(Ws[0], Ws[1])
    wp = fleet.init_worker_params(gen, _cfg())
    leaves, _ = X.tree_flatten(wp)
    assert all(l.shape[:2] == (3, N) for l in leaves)
    assert torch.equal(leaves[1][0, 0], leaves[1][0, 3])   # a common start
    assert not torch.equal(leaves[1][0, 0], leaves[1][1, 0])
    flat, spec = fleet.init_flat_spec(gen, _cfg())
    assert flat.shape == (3, N, spec.d) and flat.dtype == torch.float32
    assert all(l.shape[:2] == (3, N) for l in X.tree_flatten(
        spec.unravel(flat))[0])


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
def test_one_replicate_is_the_single_network_round(flat):
    """At R = 1 the fleet draws what the single network draws, in the same
    order: three rounds bitwise."""
    proto = P.ProtocolConfig(**KW)
    store, _ = _store()
    cfg = _cfg()
    outs = []
    for fleet in (None, FleetEngine(proto, 1, device="cpu")):
        g = torch.Generator().manual_seed(5)
        if fleet is None:
            wp = P.init_worker_params(g, cfg, N, "cpu")
            spec = X.FlatSpec(wp) if flat else None
            sim = proto.simulator("cpu")
            body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim)
            net = sim.init(g)
        else:
            wp = fleet.init_worker_params(g, cfg)
            spec = X.FlatSpec(wp, lead_axes=2) if flat else None
            body = TJ.make_round_body(cfg, proto, store, spec, "cpu",
                                      fleet=fleet)
            net = fleet.init(g)
        carry = TJ.TrajCarry(g, spec.flatten(wp) if flat else wp, net)
        carry, out = TJ.run_chunk(body, carry, 3)
        params = (carry.params if flat else
                  X.FlatSpec(carry.params, 1 if fleet is None else 2)
                  .flatten(carry.params))
        outs.append((params.reshape(N, -1), out["W"].reshape(3, N, N),
                     out["metrics"]["loss"].reshape(3),
                     out["metrics"]["param_norm"].reshape(3)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _ref_fleet_round(proto_kw, seed=3):
    rproto = RP.ProtocolConfig(**proto_kw, replicates=R)
    rfleet = rengine.FleetEngine(rproto)
    st = rfleet.init(jax.random.PRNGKey(seed))
    for i in range(2):
        st, chans, _, Ws = rfleet.round(jax.random.PRNGKey(seed + 10 + i), st)
    return rproto, rfleet, chans, Ws


def _scale(plan, want):
    return 1.0 + float(np.abs(want).max()) + 5.42 * float(
        (plan.amp / plan.c[:, None]).abs().max())


def test_fleet_flat_step_equals_the_reference_s_per_replicate():
    rproto, rfleet, rchans, rWs = _ref_fleet_round(KW)
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    rflat, rspec = rfleet.init_flat_spec(jax.random.PRNGKey(1), rcfg)
    store, rstore = _store()
    k_data, k_step = jax.random.split(jax.random.PRNGKey(11))
    keys = rfleet.split_keys(k_step)
    rstep = jax.jit(rfleet.make_fleet_step(rcfg, flat=True, spec=rspec))
    rout, rm = rstep(rflat, rstore.sample_fleet(k_data, R), keys, rchans,
                     rWs)

    wp = jax.tree_util.tree_map(
        np.asarray, rfleet.init_worker_params(jax.random.PRNGKey(1), rcfg))
    flat, _, spec = fleet_params_from_jax(wp, device="cpu")
    np.testing.assert_array_equal(flat.numpy(), np.asarray(rflat))
    u = torch.from_numpy(np.stack([
        np.array(jax.random.uniform(k, (N, B)))
        for k in jax.random.split(k_data, R)]))
    batch = store.sample_fleet(u)
    rbatch = rstore.sample_fleet(k_data, R)
    np.testing.assert_array_equal(batch["y"].numpy(), np.asarray(rbatch["y"]))
    seeds = torch.cat([ops.seed_from_key(np.asarray(jax.random.split(k)[0]))
                       .reshape(1) for k in keys])
    proto = P.ProtocolConfig(**KW, replicates=R)
    step = P.make_fleet_flat_train_step(_cfg(), proto, spec, "cpu")
    chans, Ws = port_chan(rchans), t(rWs)
    out, m = step(flat, batch, seeds, chans, Ws)
    want = np.asarray(rout)
    plan = X.plan_dynamic(proto, chans, "cpu", Ws)
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-6 * _scale(plan, want))
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(rm["loss"]),
                               rtol=1e-5)
    assert m["loss"].shape == (R,)


def test_fleet_tree_step_equals_the_reference_s_per_replicate():
    rproto, rfleet, rchans, rWs = _ref_fleet_round(KW)
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    rwp = rfleet.init_worker_params(jax.random.PRNGKey(2), rcfg)
    store, rstore = _store(seed=2)
    k_data, k_step = jax.random.split(jax.random.PRNGKey(12))
    keys = rfleet.split_keys(k_step)
    rbatch = rstore.sample_fleet(k_data, R)
    rout, rm = jax.jit(rfleet.make_fleet_step(rcfg))(rwp, rbatch, keys,
                                                       rchans, rWs)
    per = [_dynamic_normals(jax.tree_util.tree_map(lambda a: a[r], rwp),
                            keys[r]) for r in range(R)]
    normals = {f: X.tree_map(lambda *ls: torch.stack(ls),
                             *[p[f] for p in per]) for f in ("n", "m")}
    wp = X.tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree_util.tree_map(np.asarray, rwp))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rbatch.items()}
    for use_pallas in (False, True):
        proto = P.ProtocolConfig(**KW, replicates=R, use_pallas=use_pallas)
        step = P.make_fleet_train_step(_cfg(), proto, "cpu")
        out, m = step(wp, batch, None, port_chan(rchans), t(rWs),
                      normals=normals)
        got = X.FlatSpec(out, 2).flatten(out).numpy()
        want = np.concatenate([np.asarray(l).reshape(R, N, -1) for l in
                               jax.tree_util.tree_leaves(rout)], axis=-1)
        plan = X.plan_dynamic(proto, port_chan(rchans), "cpu", t(rWs))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * _scale(plan, want))
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(rm["loss"]),
                                   rtol=1e-5)


def test_power_override_equals_the_reference_s():
    from repro.net import scenarios as rscenarios
    from repro.net import simulator as rsimulator
    rsim = rsimulator.NetworkSimulator(rscenarios.get_scenario("vehicular"),
                                       N, target_epsilon=1.0, gamma=0.01)
    st = rsim.init(jax.random.PRNGKey(2))
    P_w = np.linspace(0.5, 3.0, N).astype(np.float32)
    st2, rchan, _, rW = rsim.round(jax.random.PRNGKey(3), st, P=P_w)
    sim = P.ProtocolConfig(**KW).simulator("cpu")
    chan = sim._channel(port_state(st2), t(rW), torch.from_numpy(P_w))
    # beta = 1 - alpha (alpha < 1) keeps alpha's last-bit rounding: 2^-24
    for f in ("h", "P", "alpha", "beta", "c", "sigma"):
        np.testing.assert_allclose(getattr(chan, f).numpy(),
                                   np.asarray(getattr(rchan, f)), rtol=1e-6,
                                   atol=2.0 ** -24, err_msg=f)
    # a number P is the p_dbm it stands for, bitwise
    a, b = (torch.Generator().manual_seed(4) for _ in range(2))
    hot = P.ProtocolConfig(**dict(KW, p_dbm=50.0)).simulator("cpu")
    s0 = sim.init(a)
    hot.init(b)
    _, c1, _, W1 = sim.round(a, s0, P=float(dbm_to_watts(50.0)))
    _, c2, _, W2 = hot.round(b, s0)
    assert torch.equal(c1.h, c2.h) and torch.equal(c1.sigma, c2.sigma)
    # the fleet's [R] power axis: each replicate its own power
    fleet = FleetEngine(P.ProtocolConfig(**KW), 2, power_dbm=[50.0, 60.0],
                        device="cpu")
    g = torch.Generator().manual_seed(1)
    _, chans, _, _ = fleet.round(g, fleet.init(g))
    np.testing.assert_allclose(chans.P[:, 0].numpy(),
                               dbm_to_watts([50.0, 60.0]), rtol=1e-6)


def test_batched_epsilon_and_report_equal_the_reference_s():
    kw = dict(KW, target_epsilon=0.0, sigma=0.8)
    rproto = RP.ProtocolConfig(**kw, replicates=R, accountant="rdp")
    rfleet = rengine.FleetEngine(rproto)
    rchans, _, rWs = rfleet.trajectory(jax.random.PRNGKey(7), 6)
    proto = P.ProtocolConfig(**kw, replicates=R, accountant="rdp")
    chans, Ws = port_chan(rchans), t(rWs)
    got = privacy.epsilon_trajectory_batched(proto.gamma, proto.clip, chans,
                                             proto.delta, Ws)
    want = np.asarray(rprivacy.epsilon_trajectory_batched(
        rproto.gamma, rproto.clip, rchans, rproto.delta, rWs))
    assert got.shape == (R, 6, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    rep = fleet_epsilon_report(proto, chans, Ws)
    rrep = rengine.fleet_epsilon_report(rproto, rchans, rWs)
    assert set(rep) == set(rrep)
    for k, v in rrep.items():
        if isinstance(v, (str, bool, int)):
            assert rep[k] == v, k
        else:
            np.testing.assert_allclose(rep[k], v, rtol=2e-6, err_msg=k)
    tel = fleet_round_telemetry(proto, chans, Ws)
    rtel = rengine.fleet_round_telemetry(rproto, rchans, rWs)
    for k in ("deep_fade", "participation"):
        np.testing.assert_array_equal(tel[k].numpy(), np.asarray(rtel[k]))
    np.testing.assert_allclose(tel["epsilon"].numpy(),
                               np.asarray(rtel["epsilon"]), rtol=1e-6)


def test_layouts_and_mean_ci():
    rounds = [torch.arange(6.0).reshape(2, 3) + 10 * i for i in range(4)]
    st = stack_rounds(rounds)
    assert st.shape == (2, 4, 3)
    torch.testing.assert_close(st, TJ.replicate_major(torch.stack(rounds)))
    want = np.asarray(rengine.stack_rounds([jnp.asarray(r.numpy())
                                            for r in rounds]))
    np.testing.assert_array_equal(st.numpy(), want)
    fleet = FleetEngine(P.ProtocolConfig(**KW), 3, device="cpu")
    g = torch.Generator().manual_seed(0)
    chans, _, _ = fleet.trajectory(g, 2)
    assert TJ.replicate_major(TJ.replicate_major(chans)).h.shape == (3, 2, N)
    d = TJ.replicate_major({"W": torch.zeros(5, 3, N, N)})
    assert d["W"].shape == (3, 5, N, N)
    for v in ([1.0, 1.0, 1.0], [5.0], np.random.default_rng(0).normal(
            size=40)):
        assert mean_ci(v) == pytest.approx(rengine.mean_ci(v))


def test_grid_points_and_cell_seeds_are_the_reference_s():
    kw = dict(scenarios=("iot_dense", "vehicular"), n_workers=(8, 16),
              p_dbm=(50.0, 60.0), target_epsilon=(0.5, 1.0))
    grid, rgrid = sweep.ScenarioGrid(**kw), rsweep.ScenarioGrid(**kw)
    assert list(grid.points()) == list(rgrid.points())
    assert grid.size() == rgrid.size() == 16
    assert dataclasses.asdict(grid) == dataclasses.asdict(rgrid)
    for pt in grid.points():
        assert sweep.cell_seed(7, pt) == rsweep.cell_seed(7, pt)


def _returned_keys(path: Path, fn: str) -> set:
    """The literal keys of the dict ``fn`` returns."""
    mod = ast.parse(path.read_text())
    f = next(n for n in mod.body if isinstance(n, ast.FunctionDef)
             and n.name == fn)
    ret = next(n for n in ast.walk(f) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys if isinstance(k, ast.Constant)}


def test_sweep_rows_have_the_reference_s_keys(tmp_path):
    grid = sweep.ScenarioGrid(scenarios=("iot_dense",), n_workers=(N,),
                              replicates=R, steps=2)
    out = sweep.run_grid(grid, json_path=str(tmp_path / "s.json"),
                         device="cpu")
    row = out["rows"][0]
    root = Path(__file__).resolve().parents[1]
    want = _returned_keys(root / "src/repro/fleet/sweep.py", "run_point")
    point = set(next(grid.points()))
    assert set(row) == want | point
    assert row["replicates"] == R and np.isfinite(row["acc_mean"])
    assert (tmp_path / "s.json").is_file()


def test_chip_smoke_holds_the_reference_s_sweep_keys():
    """chip_smoke.py checks the sweep's rows on the card against a copy of
    the reference's keys (it imports nothing of the reference)."""
    import importlib.util
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = _returned_keys(root / "src/repro/fleet/sweep.py", "run_point")
    assert smoke.SWEEP_KEYS == want | set(next(sweep.ScenarioGrid().points()))


def test_plain_replicate_axis_is_each_replicate_s_round():
    gen = torch.Generator().manual_seed(3)
    p = torch.randn((3, N, 300), generator=gen)
    g = torch.randn((3, N, 300), generator=gen)
    W = torch.softmax(torch.randn((3, N, N), generator=gen), -1)
    amp, listen = torch.rand((3, N), generator=gen), torch.ones(3, N)
    listen[1, 2] = 0.0
    c, sm = torch.rand(3, generator=gen) + 0.5, torch.rand(3, generator=gen)
    seeds = torch.tensor([5, -7, 2 ** 30], dtype=torch.int32)
    kw = dict(gamma=0.01, eta=0.4)
    out = ops.dp_mix_round(p, g, seeds, W, amp, c, sm, listen=listen, **kw)
    for r in range(3):
        one = ops.dp_mix_round(p[r], g[r], seeds[r], W[r], amp[r], c[r],
                               sm[r], listen=listen[r], **kw)
        assert torch.equal(out[r], one)
    with pytest.raises(ValueError, match="W must be"):
        ops.dp_mix_round(p, g, seeds, W[0], amp, c, sm, **kw)


def _count_wrappers(monkeypatch):
    """Calls of every kernel wrapper of a round (on the CPU the wrappers
    run the plain versions and launch nothing, so calls are counted)."""
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    for name in ("dp_mix_round", "dp_mix_round_sparse"):
        counted(ops, name)
    for name in ("sgd_update_leaves", "sgd_update", "dp_perturb"):
        counted(dp_ops, name)
    return calls


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "tree"])
def test_one_kernel_call_a_fleet_round_at_any_r(monkeypatch, flat):
    calls = _count_wrappers(monkeypatch)
    store, _ = _store()
    seen = []
    for reps in (2, 3):
        proto = P.ProtocolConfig(**KW, use_pallas=True)
        fleet = FleetEngine(proto, reps, device="cpu")
        g = torch.Generator().manual_seed(0)
        wp = fleet.init_worker_params(g, _cfg())
        spec = X.FlatSpec(wp, lead_axes=2) if flat else None
        body = TJ.make_round_body(_cfg(), proto, store, spec, "cpu",
                                  fleet=fleet)
        calls.clear()
        TJ.run_chunk(body, TJ.TrajCarry(g, spec.flatten(wp) if flat else wp,
                                        fleet.init(g)), 2)
        seen.append(dict(calls))
    want = {"dp_mix_round": 2} if flat else {"sgd_update_leaves": 2}
    assert seen == [want, want]


def test_fleet_telemetry_leaves_the_trajectory_bitwise():
    proto = P.ProtocolConfig(**KW)
    store, _ = _store()
    finals = []
    for spec_t in (None, tele.TelemetrySpec()):
        fleet = FleetEngine(proto, R, device="cpu")
        g = torch.Generator().manual_seed(2)
        wp = fleet.init_worker_params(g, _cfg())
        spec = X.FlatSpec(wp, lead_axes=2)
        body = TJ.make_round_body(_cfg(), proto, store, spec, "cpu",
                                  fleet=fleet, telemetry=spec_t)
        eps = (tele.init_eps_moments(R, device="cpu") if spec_t is not None
               else None)
        carry, out = TJ.run_chunk(body, TJ.TrajCarry(
            g, spec.flatten(wp), fleet.init(g), eps), 3)
        finals.append(carry.params)
        if spec_t is not None:
            assert out["telemetry"].shape == (3, R, 7)
            cols = spec_t.unpack(out["telemetry"])
            ref = fleet_round_telemetry(proto, *(TJ.replicate_major(out[k])
                                                 for k in ("chan", "W")))
            for k, v in ref.items():
                torch.testing.assert_close(cols[k], v.transpose(0, 1),
                                           rtol=0, atol=0, equal_nan=True)
            assert carry.eps.shape == (R, 29)
            assert carry.eps[:, 3].tolist() == [3.0] * R
    torch.testing.assert_close(finals[0], finals[1], rtol=0, atol=0)


@pytest.mark.parametrize("extra", [[], ["--flat-buffer"],
                                   ["--flat-buffer", "--no-scan"]],
                         ids=["tree", "flat", "flat-no-scan"])
def test_cli_replicates_on_cpu(extra):
    res = train.run(["--device", "cpu", "--hidden", "16", "--workers", "4",
                     "--steps", "3", "--dataset-size", "2000",
                     "--channel-model", "dynamic", "--scenario", "vehicular",
                     "--replicates", "2", "--eval-every", "2", *extra])
    assert res["losses"].shape == (4, 2)
    assert res["epsilon_report"]["replicates"] == 2
    assert res["epsilon_report"]["rounds"] == 4
    params = res["params"]
    lead = (params if "--flat-buffer" in extra
            else X.tree_flatten(params)[0][0]).shape[:2]
    assert lead == (2, 4)


@pytest.mark.parametrize("argv,item", [
    (["--replicates", "2", "--model-shards", "2"], "A14"),
    (["--replicates", "2", "--channel-model", "dynamic", "--scenario",
      "mesh_sparse", "--sparse-neighbors", "4"], "A20")])
def test_cli_replicates_refusals(argv, item):
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        train.parse_args(argv)
