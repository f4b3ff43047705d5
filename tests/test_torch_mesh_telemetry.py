"""Telemetry over a process-group mesh (ROADMAP A21) on gloo process
groups on the CPU (tests/_torch_dist.py, one start a mesh kind).

A trajectory of 3 dynamic rounds with every telemetry column on, on each
mesh kind: the model axis (iot_dense, 2 column windows), the worker axis
(mesh_sparse, N = 16, k = 4, 2 row blocks) and the fleet's 2-D mesh
((replicas 1, model 2), the CLI's, and (replicas 2, model 1); its R = 2
networks mix through neighbor lists, k = 3, so the sparse fleet runs
sharded, as the reference's CLI runs it with --model-shards). Every
rank's rows and ``carry.eps`` against the logical mode's (the padded
buffer on one process; the worker axis's: the unsharded buffer):

* loss, grad_norm, snr_db, deep_fade, participation, epsilon and
  ``carry.eps`` bitwise: the step's metrics come whole to every rank, and
  every rank draws the same network, so each evaluates the same channel
  columns and composes the same epsilon;
* consensus within rtol 1e-6: on two ranks it is a sum of the ranks'
  partial sums (one ``all_reduce``; the worker axis also broadcasts the
  shift row), as ``param_norm`` is, so its float32 sums add in another
  order (tests/test_torch_shard.py holds ``param_norm`` to the same);
* on a one-rank group every column bitwise (the collectives leave every
  value as it is);
* the CLI with ``--runlog-dir`` on 2 ranks: rank 0's run log alone, its
  rows those the ranks computed.
"""
import json
from pathlib import Path

import pytest
import torch

import _torch_dist as D
from repro_torch.obs import telemetry as tele

FIELDS = tele.TelemetrySpec().fields
CONSENSUS = FIELDS.index("consensus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return a.contiguous().view(torch.int32)


def _check(got: dict, want: dict, consensus_rtol: float):
    assert got["rows"].shape == want["rows"].shape
    others = [i for i in range(len(FIELDS)) if i != CONSENSUS]
    assert torch.equal(_bits(got["rows"][..., others]),
                       _bits(want["rows"][..., others]))
    assert torch.equal(_bits(got["eps"]), _bits(want["eps"]))
    g, w = got["rows"][..., CONSENSUS], want["rows"][..., CONSENSUS]
    if consensus_rtol == 0:
        assert torch.equal(_bits(g), _bits(w))
    else:
        torch.testing.assert_close(g, w, rtol=consensus_rtol, atol=0)
    assert bool((w[1:] > 0).all())          # the workers drift apart


@pytest.mark.parametrize("kind", ["model", "workers"])
def test_two_ranks_give_the_logical_mode_s_rows(kind, tmp_path):
    fn = D.telemetry_model if kind == "model" else D.telemetry_workers
    ranks = D.run_ranks(fn, 2, tmp_path)
    want = D.telemetry_trajectory(kind)
    assert want["rows"].shape == (D.TELE_ROUNDS, len(FIELDS))
    for got in ranks:
        _check(got, want, 1e-6)


def test_fleet_2d_meshes_give_the_logical_mode_s_rows(tmp_path):
    ranks = D.run_ranks(D.telemetry_fleet, 2, tmp_path)
    for name, shards in (("1x2", 2), ("2x1", 1)):
        want = D.telemetry_trajectory("fleet", shards=shards)
        assert want["rows"].shape == (D.TELE_ROUNDS, 2, len(FIELDS))
        for got in ranks:
            _check(got[name], want, 1e-6 if shards > 1 else 0)


def test_one_rank_is_bitwise_the_logical_mode(tmp_path):
    (got,) = D.run_ranks(D.telemetry_one_rank, 1, tmp_path)
    for kind in ("model", "workers", "fleet"):
        _check(got[kind], D.telemetry_trajectory(kind, shards=1), 0)


def test_cli_run_log_on_two_ranks_is_rank_0_s(tmp_path):
    runs = tmp_path / "runs"
    argv = ["--device", "cpu", "--hidden", "16", "--workers", "16",
            "--steps", "2", "--dataset-size", "2000", "--flat-buffer",
            "--channel-model", "dynamic", "--scenario", "mesh_sparse",
            "--sparse-neighbors", "4", "--eval-every", "2",
            "--worker-shards", "2", "--runlog-dir", str(runs),
            "--eps-budget", "1"]
    ranks = D.run_ranks(D.cli_ranks, 2, tmp_path, argv)
    assert ranks[1]["runlog_dir"] is None
    logs = list(runs.iterdir())
    assert logs == [Path(ranks[0]["runlog_dir"])]
    events = [json.loads(line) for line in
              (logs[0] / "events.jsonl").read_text().splitlines()]
    rows = [e for e in events if e["type"] == "round"]
    assert len(rows) == 3
    tel = ranks[0]["telemetry"]
    assert tel.shape == (3, len(FIELDS))
    for e, row in zip(rows, tel):
        for f, v in zip(FIELDS, row.tolist()):
            assert e[f] == pytest.approx(v, rel=0, abs=0, nan_ok=True), f
    for r in ranks:
        assert torch.equal(_bits(r["eps"]), _bits(ranks[0]["eps"]))
        assert torch.equal(r["losses"], ranks[0]["losses"])
    assert any(e["type"] == "warning" and "epsilon budget" in e["message"]
               for e in events)


def test_chip_smoke_reads_the_run_log_in_the_catalogue_s_order():
    """chip_smoke.py reads a two-card run's log rows by a copy of the
    telemetry columns' names, in the catalogue's order."""
    import importlib.util
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.TELEMETRY_FIELDS == FIELDS
