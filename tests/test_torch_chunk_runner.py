"""The port's ``ChunkRunner`` (``core.trajectory``), the reference's chunk
executor, on the CPU, where ``run`` executes its eager program.

Each path the runner captures on the card (chip_smoke.py's GRAPH_PATHS:
the static flat round with and without telemetry, the worker-tree round
with use_pallas, the dynamic flat and tree rounds, the fleet at R = 2 and
the sparse round) at dwfl-paper's reduced width (hidden 16, N = 6):
chunks through ``ChunkRunner.run`` are bitwise ``run_chunk``'s, the
parameters, generator state, network state, epsilon moments and every
output. The runner agrees with the reference's ``ChunkRunner.run`` on the
reference's replayed data uniforms and noise seeds within
test_torch_train.py's DRIFT_BOUND (1e-6; float32 roundings of the
gradient products and the mix, which the rounds contract). A chunk
shorter than one round, a body over a process-group mesh and one fed by
host batches are refused, the last two naming ROADMAP A7b. The CLI names
its executor, and its chunked run is bitwise the eager loop's.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.dwfl_paper import CONFIG as REF_CFG
from repro.core import exchange as RX
from repro.core import protocol as RP
from repro.core import trajectory as RTJ
from repro.data import device as ref_device
from repro_torch.configs import DWFL_PAPER
from repro_torch.convert import params_from_jax
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, FederatedBatcher,
                              classification_dataset, dirichlet_partition)
from repro_torch.kernels.dp_mix import ops
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
_SMOKE = importlib.util.spec_from_file_location("chip_smoke",
                                                ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)

N, B, HIDDEN = 6, 8, 16
SMALL = dict(device="cpu", N=N, hidden=HIDDEN, dataset=400, batch=B, R=2,
             k=4)
DRIFT_BOUND = 1e-6
CHUNKS = (1, 3, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunks(run, carry, cuts=CHUNKS):
    outs = []
    for k in cuts:
        carry, out = run(carry, k)
        outs.append(out)
    return carry, outs


@pytest.mark.parametrize("path", chip_smoke.GRAPH_PATHS)
def test_runner_is_bitwise_run_chunk(path):
    body, carry = chip_smoke.graph_path(path, **SMALL)
    twin = TJ.copy_carry(carry)
    runner = TJ.ChunkRunner(body)
    got = chip_smoke.chunk_record(*_chunks(runner.run, carry))
    want = chip_smoke.chunk_record(*_chunks(
        lambda c, k: TJ.run_chunk(body, c, k), twin))
    assert got.keys() == want.keys()
    assert [n for n in want if not chip_smoke.same_bits(got[n], want[n])] \
        == []
    # the CPU runs the eager program: nothing is captured
    assert runner.trace_counts() == {}


def test_runner_keeps_telemetry_and_the_moments():
    body, carry = chip_smoke.graph_path("flat telemetry", **SMALL)
    carry, outs = _chunks(TJ.ChunkRunner(body).run, carry)
    assert [o["telemetry"].shape for o in outs] == [(k, 7) for k in CHUNKS]
    assert float(carry.eps[3]) == sum(CHUNKS)        # rounds composed


def _reference_draws(key, rounds):
    """The reference body's per-round data uniforms and noise seeds (its
    key discipline: the round key splits into the data key and the step
    key)."""
    draws = []
    for _ in range(rounds):
        key, sk = jax.random.split(key)
        k_data, k_step = jax.random.split(sk)
        u = torch.from_numpy(np.array(jax.random.uniform(k_data, (N, B))))
        seed = ops.seed_from_key(np.asarray(jax.random.split(k_step, 3)[0]))
        draws.append((u, seed))
    return draws


def test_runner_matches_the_reference_chunk_runner():
    kw = dict(n_workers=N, gamma=0.01, eta=0.4, clip=1.0, target_epsilon=1.0)
    rcfg = REF_CFG.replace(d_model=HIDDEN)
    wp = RP.init_worker_params(jax.random.PRNGKey(4), rcfg, N)
    rspec = RX.FlatSpec(wp)
    x, y = classification_dataset(400, seed=4)
    parts = dirichlet_partition(y, N, seed=4)
    rbody = RTJ.make_round_body(
        rcfg, RP.ProtocolConfig(**kw),
        ref_device.ClassificationStore.build(x, y, parts, B), flat=True,
        unravel_row=rspec.unravel_row)
    key = jax.random.PRNGKey(7)
    # before the reference's run, which donates its carry (the key too)
    draws = iter(_reference_draws(key, sum(CHUNKS)))
    rcarry, routs = _chunks(RTJ.ChunkRunner(rbody).run,
                            RTJ.TrajCarry(key, rspec.flatten(wp)))

    flat, _, spec = params_from_jax(jax.tree_util.tree_map(np.asarray, wp),
                                    device="cpu")
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    step = P.make_flat_train_step(cfg, P.ProtocolConfig(**kw), spec, "cpu")
    store = ClassificationStore.build(x, y, parts, B, device="cpu")

    def body(carry):
        u, seed = next(draws)
        params, metrics = step(carry.params, store.sample(u), seed)
        return carry._replace(params=params), {"metrics": metrics}

    carry, outs = _chunks(TJ.ChunkRunner(body).run,
                          TJ.TrajCarry(torch.Generator(), flat))
    drift = float(np.abs(carry.params.numpy()
                         - np.asarray(rcarry.params)).max())
    assert drift < DRIFT_BOUND, drift
    for out, rout in zip(outs, routs):
        np.testing.assert_allclose(out["metrics"]["loss"].numpy(),
                                   np.asarray(rout["metrics"]["loss"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("k", [0, -2])
def test_program_refuses_a_chunk_shorter_than_one(k):
    body, carry = chip_smoke.graph_path("flat", **SMALL)
    runner = TJ.ChunkRunner(body)
    with pytest.raises(ValueError, match="chunk length must be >= 1"):
        runner.program(k)
    with pytest.raises(ValueError, match="chunk length must be >= 1"):
        runner.run(carry, k)


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_runner_refuses_a_mesh_body(one_rank_group):
    """A body over a process-group mesh keeps run_chunk: its collectives
    stay eager (ROADMAP A7b)."""
    from repro_torch.core import exchange as X
    from repro_torch.launch.mesh import make_worker_mesh
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    proto = chip_smoke.dynamic_proto(N, "mesh_sparse", sparse_neighbors=4)
    wp = P.init_worker_params(torch.Generator().manual_seed(0), cfg, N, "cpu")
    x, y = classification_dataset(400, seed=0)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, N, seed=0),
                                      B, device="cpu")
    body = TJ.make_round_body(cfg, proto, store, X.FlatSpec(wp), "cpu",
                              sim=proto.simulator("cpu"),
                              worker_mesh=make_worker_mesh(1, device="cpu"))
    with pytest.raises(ValueError, match="process-group mesh.*ROADMAP A7b"):
        TJ.ChunkRunner(body)


def test_runner_refuses_host_batches():
    """A body fed by host batches (--no-scan's) takes run_per_round: a
    graph would replay one upload."""
    x, y = classification_dataset(400, seed=0)
    parts = dirichlet_partition(y, N, seed=0)
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    src = TJ.HostBatches(FederatedBatcher(x, y, parts, B, seed=0), "cpu")
    body = TJ.make_round_body(cfg, P.ProtocolConfig(n_workers=N), src,
                              device="cpu")
    with pytest.raises(ValueError, match="host batches.*ROADMAP A7b"):
        TJ.ChunkRunner(body)


def test_copy_carry_is_independent():
    body, carry = chip_smoke.graph_path("dynamic flat", **SMALL)
    twin = TJ.copy_carry(carry)
    assert twin.generator is not carry.generator
    assert torch.equal(twin.generator.get_state(), carry.generator.get_state())
    for a, b in zip(TJ.tree_tensors((carry.params, carry.net)),
                    TJ.tree_tensors((twin.params, twin.net))):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


CLI = ["--device", "cpu", "--hidden", "16", "--workers", "4", "--steps", "5",
       "--dataset-size", "2000", "--eval-every", "2"]


@pytest.mark.parametrize("extra", [[], ["--flat-buffer"],
                                   ["--flat-buffer", "--channel-model",
                                    "dynamic", "--scenario", "iot_dense"]],
                         ids=["tree", "flat", "dynamic"])
def test_cli_names_its_executor_and_runs_the_eager_loop(extra, capsys,
                                                        monkeypatch):
    """On the CPU the CLI's chunked run goes through ChunkRunner's eager
    program: bitwise the run_chunk loop it ran before, chunk for chunk
    (plan_chunks cuts at every eval); --no-scan keeps run_per_round."""
    res = train.run(CLI + extra)
    out = capsys.readouterr().out
    assert "[train] executor: ChunkRunner (its eager program)" in out
    monkeypatch.setattr(TJ.ChunkRunner, "run",
                        lambda self, carry, k: TJ.run_chunk(self._body,
                                                            carry, k))
    eager = train.run(CLI + extra)
    assert chip_smoke.same_bits(res["losses"], eager["losses"])
    for a, b in zip(TJ.tree_tensors(res["params"]),
                    TJ.tree_tensors(eager["params"])):
        assert chip_smoke.same_bits(a, b)
    monkeypatch.undo()
    capsys.readouterr()
    per_round = train.run(CLI + extra + ["--no-scan"])
    assert "[train] executor: run_per_round" in capsys.readouterr().out
    assert per_round["losses"].shape == res["losses"].shape
    assert torch.isfinite(per_round["losses"]).all()


def test_cli_keeps_run_chunk_for_an_lm():
    """An LM's rounds are device-bound (PERF §5): the CLI picks run_chunk
    up front and says so."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.run(["--device", "cpu", "--arch", "olmo-1b", "--reduced",
                   "--seq-len", "32", "--workers", "2", "--steps", "0",
                   "--batch-size", "2", "--eval-every", "0"])
    assert "[train] executor: run_chunk (eager rounds; an LM body" \
        in buf.getvalue()


def test_cli_keeps_run_chunk_for_a_sparse_round(capsys):
    """A sparse round is device-bound at worker scale, where a graph of it
    is slower and reserves more (PERF §6): the CLI picks run_chunk up
    front, says so, and its losses are finite."""
    res = train.run(CLI + ["--flat-buffer", "--channel-model", "dynamic",
                           "--scenario", "mesh_sparse", "--sparse-neighbors",
                           "3"])
    assert "[train] executor: run_chunk (eager rounds; a sparse round's " \
        "body" in capsys.readouterr().out
    assert torch.isfinite(res["losses"]).all()
