"""Telemetry and run logs on the port (ROADMAP A11), against the reference
on the CPU.

Channels and Ws are replayed from the reference's simulator (iot_dense at
an even N, so the median of |h|^2 is the midpoint of two values). The
channel scalars are float32 of the same channel: rtol 1e-6 (``snr_db``:
of its linear value, 4.4e-6 dB), except ``deep_fade`` and
``participation``, which are shares of integer counts and must be equal.
``consensus_distance`` sums in another order than XLA: rtol 1e-5, and near consensus, where the shifted identity's two terms
nearly cancel (bounded by 1 + N), rtol 1e-4. The trajectory with
telemetry on is bitwise the trajectory with it off. Run directories of
either package are read by both summarizers with the same event counts
and keys.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import protocol as RP
from repro.net import sparse as rsparse
from repro.obs import report as rreport
from repro.obs import telemetry as rtele
from repro_torch import obs
from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, classification_dataset,
                              dirichlet_partition)
from repro_torch.launch import train
from repro_torch.net.sparse import SparseW
from repro_torch.obs import guard, report
from repro_torch.obs import telemetry as tele
from test_torch_net import port_chan, ref_round, t

N, B, HIDDEN = 6, 8, 16
KW = dict(scheme="dwfl", n_workers=N, gamma=0.01, eta=0.4, clip=1.0,
          target_epsilon=1.0, channel_model="dynamic", scenario="iot_dense")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spec_fields_pack_unpack_as_the_reference():
    for kw in ({}, {"consensus": False, "snr_db": False},
               {"loss": False, "epsilon": False}):
        spec, rspec = tele.TelemetrySpec(**kw), rtele.TelemetrySpec(**kw)
        assert spec.fields == rspec.fields and spec.n_fields == rspec.n_fields
        vals = {f: torch.tensor([i + 0.5, -i]) for i, f in
                enumerate(spec.fields)}
        packed = spec.pack(vals)
        assert packed.shape == (2, spec.n_fields)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(rspec.pack(
                {f: jnp.asarray(v.numpy()) for f, v in vals.items()})))
        back = spec.unpack(packed)
        assert list(back) == list(spec.fields)
        for f in spec.fields:
            torch.testing.assert_close(back[f], vals[f])
    with pytest.raises(ValueError, match="columns"):
        tele.TelemetrySpec().unpack(torch.zeros(3, 2))


@pytest.mark.parametrize("near", [False, True], ids=["spread", "near"])
@pytest.mark.parametrize("worker_axis", [0, 1])
def test_consensus_distance_equals_reference(worker_axis, near):
    rng = np.random.default_rng(4)
    shape = (3, 8) if worker_axis else (8,)
    scale = 1e-4 if near else 1.0
    tree = {"a": rng.normal(size=(1,) * (worker_axis + 1) + (50, 7))
            + scale * rng.normal(size=shape + (50, 7)),
            "b": rng.normal(size=(1,) * (worker_axis + 1) + (33,))
            + scale * rng.normal(size=shape + (33,))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    got = tele.consensus_distance({k: torch.from_numpy(v)
                                   for k, v in tree.items()}, worker_axis)
    want = np.asarray(rtele.consensus_distance(
        {k: jnp.asarray(v) for k, v in tree.items()}, worker_axis))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4 if near else 1e-5)
    # and against the float64 truth, as the reference's own test holds it
    x64 = np.concatenate([v.reshape(shape + (-1,)).astype(np.float64)
                          for v in tree.values()], -1)
    truth = np.sqrt(np.mean(np.sum((x64 - x64.mean(worker_axis, keepdims=True))
                                   ** 2, -1), -1))
    np.testing.assert_allclose(got.numpy(), truth, rtol=1e-3)


def test_consensus_distance_on_the_flat_buffer_is_the_tree_s():
    rng = np.random.default_rng(5)
    tree = {"w": torch.from_numpy(rng.normal(size=(4, 5, 3)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))}
    flat = X.FlatSpec(tree).flatten(tree)
    torch.testing.assert_close(tele.consensus_distance(flat),
                               tele.consensus_distance(tree), rtol=1e-6,
                               atol=0)


@pytest.fixture(scope="module")
def replayed():
    """An iot_dense round of the reference at even N: churn and radio
    range leave some workers unheard."""
    _, _, rchan, _, rW = ref_round("iot_dense", N, 7, rounds=4, sigma=0.5,
                                   sigma_m=0.3, p_dbm=30.0)
    return rchan, rW


def _ws(rW, kind):
    """W as None, dense, or a neighbor list, in both packages."""
    if kind == "none":
        return None, None
    if kind == "dense":
        return t(rW), rW
    rsw = rsparse.sparsify_dense(jnp.asarray(rW), 3)
    return SparseW(idx=t(rsw.idx), w=t(rsw.w), self_w=t(rsw.self_w)), rsw


@pytest.mark.parametrize("kind", ["none", "dense", "sparse"])
def test_channel_scalars_and_epsilon_equal_reference(replayed, kind):
    rchan, rW = replayed
    W, rWk = _ws(rW, kind)
    spec = tele.TelemetrySpec()
    chan = port_chan(rchan)
    got = tele.channel_scalars(spec, chan, W)
    want = rtele.channel_scalars(rtele.TelemetrySpec(), rchan, rWk)
    assert set(got) == set(want) == {"snr_db", "deep_fade", "participation"}
    for k in ("deep_fade", "participation"):
        assert float(got[k]) == float(want[k]), k
    # rtol 1e-6 of the linear SNR is 10 log10(1 + 1e-6) = 4.4e-6 dB
    np.testing.assert_allclose(float(got["snr_db"]), float(want["snr_db"]),
                               rtol=0, atol=4.4e-6)
    proto, rproto = P.ProtocolConfig(**KW), RP.ProtocolConfig(**KW)
    np.testing.assert_allclose(float(tele.epsilon_round(proto, chan, W)),
                               float(rtele.epsilon_round(rproto, rchan, rWk)),
                               rtol=1e-6)
    np.testing.assert_allclose(tele.rdp_round(proto, chan, W).numpy(),
                               np.asarray(rtele.rdp_round(rproto, rchan, rWk)),
                               rtol=1e-6)
    # the round's own accessor is the same function
    for k, v in chan.telemetry(W=W).items():
        assert torch.equal(v, got[k]) or bool(torch.isnan(v) & torch.isnan(got[k]))


def test_median_is_jnp_s_midpoint_at_even_n():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [1.0, 1.0, 7.0, 5.0]])
    np.testing.assert_array_equal(tele._median(x).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x.numpy()),
                                                        axis=-1)))
    assert float(tele._median(torch.tensor([3.0, 1.0, 2.0]))) == 2.0
    # deep_fade at the even N of the replayed round: a floor between the
    # two middle values, where the lower value's floor would differ
    h = torch.tensor([1.0, 1.0, 0.3, 0.12, 1.0, 0.1])
    chan = dataclasses.replace(port_chan(ref_round("iot_dense", N, 7)[2]),
                               h=h)
    spec = tele.TelemetrySpec(deep_fade_rel_db=-1.0)
    rchan = dataclasses.replace(ref_round("iot_dense", N, 7)[2],
                                h=jnp.asarray(h.numpy()))
    assert float(tele.channel_scalars(spec, chan)["deep_fade"]) == float(
        rtele.channel_scalars(rtele.TelemetrySpec(deep_fade_rel_db=-1.0),
                              rchan)["deep_fade"])


def test_a_round_with_no_listener_gives_nan_snr(replayed):
    rchan, _ = replayed
    W = torch.eye(N)
    got = tele.channel_scalars(tele.TelemetrySpec(), port_chan(rchan), W)
    want = rtele.channel_scalars(rtele.TelemetrySpec(), rchan,
                                 jnp.eye(N, dtype=jnp.float32))
    assert bool(torch.isnan(got["snr_db"])) and bool(jnp.isnan(want["snr_db"]))
    assert float(got["participation"]) == float(want["participation"]) == 0.0


def test_stacked_rounds_are_each_round_s_scalars(replayed):
    """Leading axes (a chunk's rounds) reduce over the worker axis only."""
    rchan, rW = replayed
    chan = port_chan(rchan)
    two = dataclasses.replace(chan, **{f: torch.stack([getattr(chan, f)] * 2)
                                       for f in ("h", "P", "alpha", "beta",
                                                 "c", "sigma", "sigma_m")})
    Ws = torch.stack([t(rW), torch.eye(N)])
    got = tele.channel_scalars(tele.TelemetrySpec(), two, Ws)
    for i, W in enumerate((t(rW), torch.eye(N))):
        one = tele.channel_scalars(tele.TelemetrySpec(), chan, W)
        for k, v in one.items():
            torch.testing.assert_close(got[k][i], v, equal_nan=True)


def test_accumulate_eps_and_its_refusals():
    acc = tele.init_eps_moments(device="cpu")
    assert acc.shape == (4 + 25,)
    assert tele.init_eps_moments(3, device="cpu").shape == (3, 29)
    rdp = torch.arange(25, dtype=torch.float32)
    a = tele.accumulate_eps(acc, torch.tensor(0.5), rdp)
    want = np.asarray(rtele.accumulate_eps(rtele.init_eps_moments(),
                                           jnp.float32(0.5),
                                           jnp.arange(25, dtype=jnp.float32)))
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-7)
    with pytest.raises(ValueError, match="RDP ledger"):
        tele.accumulate_eps(acc, 0.5)
    legacy = tele.init_eps_moments(n_orders=0, device="cpu")
    with pytest.raises(ValueError, match="legacy"):
        tele.accumulate_eps(legacy, 0.5, rdp)
    np.testing.assert_allclose(tele.accumulate_eps(legacy, 0.5).numpy(),
                               want[:4], rtol=1e-7)


def _body(flat, dynamic, telemetry, seed=2):
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    kw = dict(KW, scenario="vehicular") if dynamic else dict(
        KW, channel_model="static")
    proto = P.ProtocolConfig(**kw)
    wp = P.init_worker_params(torch.Generator().manual_seed(seed), cfg, N,
                              "cpu")
    spec = X.FlatSpec(wp) if flat else None
    x, y = classification_dataset(400, seed=seed)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, N,
                                                                seed=seed),
                                      B, device="cpu")
    sim = proto.simulator("cpu") if dynamic else None
    body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim,
                              telemetry=telemetry)
    g = torch.Generator().manual_seed(9)
    eps = (tele.init_eps_moments(device="cpu") if telemetry is not None
           else None)
    return proto, body, TJ.TrajCarry(g, spec.flatten(wp) if flat else wp,
                                     sim.init(g) if dynamic else None, eps)


@pytest.mark.parametrize("flat,dynamic", [(True, False), (True, True),
                                          (False, False)],
                         ids=["static-flat", "dynamic-flat", "tree"])
def test_telemetry_leaves_the_trajectory_bitwise(flat, dynamic):
    finals = []
    for spec in (None, tele.TelemetrySpec()):
        proto, body, carry = _body(flat, dynamic, spec)
        outs = []
        for k in (2, 3):
            carry, out = TJ.run_chunk(body, carry, k)
            outs.append(out)
        params = carry.params if flat else X.flatten_worker_tree(carry.params)
        finals.append((params, torch.cat([o["metrics"]["loss"]
                                          for o in outs])))
        if spec is not None:
            rows = torch.cat([o["telemetry"] for o in outs])
            assert rows.shape == (5, 7)
            cols = spec.unpack(rows)
            torch.testing.assert_close(cols["loss"], finals[-1][1])
            assert float(cols["consensus"][0]) == 0.0     # a common start
            eps = cols["epsilon"]
            m = carry.eps
            assert float(m[3]) == 5.0
            torch.testing.assert_close(m[0], eps.sum(), rtol=1e-6, atol=0)
            if dynamic:
                traj = TJ.concat_chunks(outs)
                want = tele.epsilon_round(proto, traj["chan"], traj["W"])
                torch.testing.assert_close(eps, want, rtol=0, atol=0)
                assert float(eps.max()) <= 1.0 + 1e-5   # calibrated to 1
            else:
                assert torch.equal(eps, eps[:1].expand(5))  # constants
    for a, b in zip(*finals):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_per_round_executor_refuses_telemetry():
    _, body, carry = _body(True, False, tele.TelemetrySpec())
    with pytest.raises(ValueError, match="chunked"):
        TJ.run_per_round(body, carry, 1)


def _summaries(run_dir):
    return rreport.summarize_run(run_dir), report.summarize_run(run_dir)


def test_port_run_directory_reads_in_both_reports(tmp_path):
    log = tmp_path / "evals.jsonl"
    res = train.run(["--device", "cpu", "--hidden", "16", "--workers", "4",
                     "--steps", "5", "--eval-every", "3", "--dataset-size",
                     "2000", "--flat-buffer", "--channel-model", "dynamic",
                     "--scenario", "iot_dense", "--runlog-dir",
                     str(tmp_path / "runs"), "--eps-budget", "0.01",
                     "--log", str(log)])
    run_dir = res["runlog_dir"]
    ref, port = _summaries(run_dir)
    assert ref["event_counts"] == port["event_counts"]
    assert set(ref) == set(port) and set(ref["telemetry"]) == set(
        port["telemetry"])
    assert port["event_counts"]["round"] == 6
    assert port["event_counts"]["warning"] == 2      # 80% and exceeded
    assert port["event_counts"]["epsilon_report"] == 1
    man = json.loads((run_dir / "manifest.json").read_text())
    rman = set(robs.RunLog.read_manifest(run_dir))
    assert set(man) >= rman and man["jax"] is None and man["torch"]
    assert man["status"] == "ok" and man["telemetry"] == list(
        tele.TelemetrySpec().fields)
    assert res["telemetry"].shape == (6, 7)
    assert [json.loads(l)["step"] for l in log.read_text().splitlines()] == [
        0, 3]
    # the last epsilon event is the carry's moments, composed
    eps_events = robs.RunLog.read_events(run_dir, "epsilon")
    e, _ = P.privacy.compose_from_moments(res["eps_moments"].numpy(), 1e-5)
    assert eps_events[-1]["rounds"] == 4
    assert port["epsilon"]["eps_composed"] > 0 and e >= port["epsilon"][
        "eps_composed"]
    assert report.main([str(run_dir.parent)]) == 0


def test_reference_run_directory_reads_in_the_port_s_report(tmp_path):
    with robs.RunLog.open(tmp_path / "ref", kind="train", config={"a": 1},
                          seed=3) as log:
        for i in range(3):
            log.round_metrics(i, loss=1.0 / (i + 1), epsilon=0.5)
        log.eval_metrics(step=2, loss=0.3, eval_loss=0.4, eval_acc=0.5)
        log.epsilon(step=2, eps_round=0.5, eps_composed=1.2,
                    delta_composed=3e-5, rounds=3)
        log.warn("budget", step=2)
    ref, port = _summaries(tmp_path / "ref")
    assert ref["event_counts"] == port["event_counts"] == {
        "close": 1, "epsilon": 1, "eval": 1, "round": 3, "warning": 1}
    assert json.dumps(ref, default=str) == json.dumps(port, default=str)


def test_watchdogs_warn_at_the_reference_s_thresholds():
    fired, rfired = [], []
    dog = obs.EpsilonBudgetWatchdog(2.0, on_warn=lambda m, **kw: fired.append(m))
    rdog = robs.EpsilonBudgetWatchdog(2.0,
                                      on_warn=lambda m, **kw: rfired.append(m))
    for e in (1.0, 1.59, 1.6, 1.9, 2.0, 5.0):
        assert dog.check(e) == rdog.check(e)
    assert fired == rfired and len(fired) == 2
    with pytest.raises(ValueError):
        obs.EpsilonBudgetWatchdog(0.0)

    class Counts:
        n = {"a": 1}

        def trace_counts(self):
            return dict(self.n)

    class Log:
        events, warnings = [], []

        def compile_event(self, what, **kw):
            self.events.append(what)

        def warn(self, msg, **kw):
            self.warnings.append(msg)

    c, log = Counts(), Log()
    dog = obs.RetraceWatchdog(c, runlog=log, label="kernels")
    assert dog.check(0) == 0 and log.events == ["kernels[a]"]
    assert dog.check(1) == 0
    c.n = {"a": 3}
    assert dog.check(2) == 2 and dog.retraces == 2
    assert "kernels[a] compiled 2 more time(s) at step 2" in log.warnings[0]


def test_guards_on_the_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("touched torch.cuda")
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", boom)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", boom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with guard.no_implicit_transfers(True, "cpu"):
        pass
    with guard.no_implicit_transfers(True):
        pass

    class Grows:
        n = 0

        def trace_counts(self):
            self.n += 1
            return {"k": self.n}

    with guard.retrace_guard(guard.LibraryBuilds(), label="x") as g:
        pass
    assert g.new_traces == 0
    with pytest.raises(guard.RetraceError, match="1 rebuild"):
        with guard.retrace_guard(Grows()):
            pass
    with pytest.raises(TypeError):
        guard.retrace_guard(object()).__enter__()


def test_guard_restores_the_mode_on_an_exception(monkeypatch):
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: 0 if modes[-1] == "default" else 2)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with pytest.raises(KeyError):
        with guard.no_implicit_transfers(True, "cuda"):
            assert modes[-1] == "error"
            raise KeyError("x")
    assert modes == ["default", "error", 0]


@pytest.mark.parametrize("argv,match", [
    (["--telemetry", "on", "--no-scan"], "chunked trajectory"),
    (["--eps-budget", "1.0"], "needs telemetry"),
    (["--eps-budget", "1.0", "--telemetry", "off", "--runlog-dir", "x"],
     "needs telemetry"),
    (["--replicates", "2"], "requires --channel-model dynamic")])
def test_cli_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        train.parse_args(argv)


def test_cli_telemetry_flags_parse():
    args = train.parse_args(["--runlog-dir", "r", "--no-transfer-guard",
                             "--log", "l"])
    assert train.telemetry_spec(args) is not None and args.no_transfer_guard
    assert train.telemetry_spec(train.parse_args(
        ["--runlog-dir", "r", "--no-scan"])) is None
    assert train.telemetry_spec(train.parse_args([])) is None
