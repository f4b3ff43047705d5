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
shorter than one round and a body fed by host batches are refused, the
latter naming ROADMAP A7b; a body over a mesh (the model axis, the
fleet's (1, 1) mesh, the worker axis) is taken, unmarked whatever the
mesh's device and size, and run bitwise run_chunk over a one-rank gloo
mesh. --remat's checkpoint keeps no RNG state and gives the gradients
without it. The CLI names its executor: ChunkRunner for the MLP, for
every LM family, for a sparse round (an LM's and a worker-axis one's
included, its rounds writing the buffer in place) and for model-axis and
worker-axis meshes over two gloo ranks; its chunked run is bitwise the
eager loop's.
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


def test_remat_keeps_no_rng_state_and_the_same_gradients(monkeypatch):
    """--remat's torch.utils.checkpoint keeps no RNG state
    (preserve_rng_state=False: reading the card's default generator fails
    inside a capture). An LM's forward draws nothing, so its gradients
    are bitwise those without remat and those of checkpoint's default
    (preserve_rng_state=True), on a reduced olmo-1b flat pass."""
    import torch.utils.checkpoint as ckpt
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import exchange as X
    from repro_torch.data import LMStore, lm_dataset
    cfg = get_arch("olmo-1b").reduced()
    gen = torch.Generator().manual_seed(0)
    wp = P.init_worker_params(gen, cfg, 2, "cpu")
    spec = X.FlatSpec(wp)
    batch = LMStore.build(lm_dataset(4000, cfg.vocab_size, seed=0), 2, 2, 32,
                          "cpu").draw(gen)
    proto = P.ProtocolConfig(n_workers=2)
    flat = spec.flatten(wp)
    seen, checkpoint = [], ckpt.checkpoint

    def recorded(*args, **kw):
        seen.append(kw.get("preserve_rng_state", True))
        return checkpoint(*args, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", recorded)
    runs = [P.make_flat_local_pass(cfg, proto, spec, remat=r)(flat, batch)
            for r in (True, False)]
    monkeypatch.setattr(ckpt, "checkpoint", lambda *a, **kw: recorded(
        *a, **dict(kw, preserve_rng_state=True)))
    runs.append(P.make_flat_local_pass(cfg, proto, spec, remat=True)(flat,
                                                                     batch))
    assert seen == [False, True]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert chip_smoke.same_bits(a, b)


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


def _mesh_body(kind: str, dress=lambda mesh: mesh):
    """(body, carry) over a one-rank gloo mesh as the CLI builds it under
    torchrun: the model axis (iot_dense, one window), the fleet on a (1,
    1) mesh (R = 2) or the worker axis (mesh_sparse, k 4); the body is
    given ``dress(mesh)``."""
    from repro_torch.core import exchange as X
    from repro_torch.launch.mesh import make_shard_mesh, make_worker_mesh
    if kind == "model":
        return chip_smoke.mesh_graph_path(
            "mesh model", dress(make_shard_mesh(1, device="cpu")),
            **MESH_SMALL)
    if kind == "fleet":
        return chip_smoke.mesh_graph_path(
            "mesh fleet", dress(make_shard_mesh(1, n_replicas=1,
                                                device="cpu")),
            R=2, **MESH_SMALL)
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    proto = chip_smoke.dynamic_proto(N, "mesh_sparse", sparse_neighbors=4)
    gen = torch.Generator().manual_seed(0)
    wp = P.init_worker_params(gen, cfg, N, "cpu")
    x, y = classification_dataset(400, seed=0)
    store = ClassificationStore.build(x, y, dirichlet_partition(y, N, seed=0),
                                      B, device="cpu")
    sim = proto.simulator("cpu")
    spec = X.FlatSpec(wp)
    body = TJ.make_round_body(cfg, proto, store, spec, "cpu", sim=sim,
                              worker_mesh=dress(make_worker_mesh(
                                  1, device="cpu")))
    return body, TJ.TrajCarry(gen, spec.flatten(wp), sim.init(gen))


MESH_SMALL = dict(device="cpu", hidden=HIDDEN, dataset=400, batch=B)


class _Cards:
    """The one-rank gloo ``mesh`` dressed as a DeviceMesh of ``n`` NCCL
    ranks: its device type "cuda" and, asked without a dimension, its
    size ``n`` (what a mark of the body would read of a mesh); every
    other attribute and a dimension's size the mesh's own."""

    def __init__(self, mesh, n: int):
        self._mesh, self.n = mesh, n
        self.device_type = "cuda"

    def size(self, dim=None) -> int:
        return self.n if dim is None else self._mesh.size(dim)

    def __getattr__(self, name):
        return getattr(self._mesh, name)


@pytest.mark.parametrize("kind", ["model", "fleet", "workers"])
def test_runner_refuses_a_mesh_body(kind, one_rank_group):
    """The refusal this test held is gone: a body over an NCCL mesh of one
    or two ranks carries no ``uncapturable`` mark, keeps its mesh
    (``body.mesh``), and a runner takes it, to be closed before any
    process group is destroyed (NCCL's destroy waits for a graph of its
    collectives); over a gloo mesh it is not. Its capture over two NCCL
    ranks: the gpu cases ``test_two_card_graph_*`` and chip_smoke's
    mesh_graph_phase."""
    from repro_torch import runtime
    for n in (1, 2):
        body, _ = _mesh_body(kind, lambda mesh: _Cards(mesh, n))
        assert getattr(body, "uncapturable", None) is None
        assert isinstance(body.mesh, _Cards) and body.mesh.n == n
        assert TJ.ChunkRunner(body) in runtime._CLOSE_BEFORE_DESTROY
    body, _ = _mesh_body(kind)
    assert body.mesh.device_type == "cpu"
    assert TJ.ChunkRunner(body) not in runtime._CLOSE_BEFORE_DESTROY


@pytest.mark.parametrize("kind", ["model", "fleet", "workers"])
def test_destroying_the_group_closes_a_runner_over_nccl(kind, tmp_path):
    """A runner over an NCCL mesh holds graphs of its collectives, which
    NCCL's destroy of their communicator waits for forever (a run on two
    cards hung there): ``torch.distributed.destroy_process_group`` frees
    them first, whoever calls it, and a runner over gloo keeps its own.
    Here a graph is a stand-in: the CPU captures none."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        nccl = TJ.ChunkRunner(_mesh_body(
            kind, lambda mesh: _Cards(mesh, 2))[0])
        gloo = TJ.ChunkRunner(_mesh_body(kind)[0])
        for runner in (nccl, gloo):
            runner._graphs[4] = object()
    finally:
        dist.destroy_process_group()
    assert nccl.trace_counts() == {} and gloo.trace_counts() == {4: 1}


@pytest.mark.parametrize("kind", ["model", "fleet", "workers"])
def test_runner_runs_a_one_rank_mesh_body_bitwise(kind, one_rank_group):
    """A body over a one-rank process-group mesh goes through ChunkRunner
    (its eager program on the CPU), bitwise run_chunk, the collectives
    with it."""
    body, carry = _mesh_body(kind)
    twin = TJ.copy_carry(carry)
    got = chip_smoke.chunk_record(*_chunks(TJ.ChunkRunner(body).run, carry))
    want = chip_smoke.chunk_record(*_chunks(
        lambda c, k: TJ.run_chunk(body, c, k), twin))
    assert got.keys() == want.keys()
    assert [n for n in want if not chip_smoke.same_bits(got[n], want[n])] \
        == []


def test_runner_close_frees_its_graphs_and_keeps_the_carry():
    """``close()``, which the end of a ``with`` block calls (and the CLI
    before it destroys a process group: NCCL keeps a communicator while
    a graph of its collectives exists), forgets the runner's graphs; the
    carry it returned stays whole and a later chunk runs, bitwise
    run_chunk."""
    body, carry = chip_smoke.graph_path("sparse", **SMALL)
    twin = TJ.copy_carry(carry)
    with TJ.ChunkRunner(body) as runner:
        carry, _ = runner.run(carry, 2)
        runner._graphs[2] = object()   # a stand-in: the CPU captures none
    assert runner.trace_counts() == {}
    carry, out = runner.run(carry, 3)
    twin, _ = TJ.run_chunk(body, twin, 2)
    twin, want = TJ.run_chunk(body, twin, 3)
    got, ref = (chip_smoke.chunk_record(c, [o])
                for c, o in ((carry, out), (twin, want)))
    assert [n for n in ref if not chip_smoke.same_bits(got[n], ref[n])] == []


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


LM_CLI = ["--device", "cpu", "--reduced", "--seq-len", "32", "--workers",
          "2", "--batch-size", "2", "--eval-every", "0"]


def test_cli_keeps_run_chunk_for_an_lm(capsys):
    """An LM's sparse round, which ran run_chunk under the sparse rule,
    takes ChunkRunner as every LM round does
    (test_cli_runs_an_lm_through_chunk_runner), its rounds writing the
    buffer in place (marked ``writes_into``); its losses are finite."""
    res = train.run(LM_CLI + ["--arch", "olmo-1b", "--steps", "2",
                              "--workers", "4", "--flat-buffer",
                              "--channel-model", "dynamic", "--scenario",
                              "mesh_sparse", "--sparse-neighbors", "2"])
    assert "[train] executor: ChunkRunner (its eager program)" \
        in capsys.readouterr().out
    assert torch.isfinite(res["losses"]).all()


def test_cli_runs_an_lm_through_chunk_runner(capsys, monkeypatch):
    """An LM's chunks go through ChunkRunner, as the reference's CLI runs
    every body: the CLI names it up front, and on the CPU its eager
    program is bitwise the run_chunk loop, chunk for chunk."""
    argv = LM_CLI + ["--arch", "olmo-1b", "--steps", "3", "--chunk-rounds",
                     "2"]
    res = train.run(argv)
    assert "[train] executor: ChunkRunner (its eager program)" \
        in capsys.readouterr().out
    monkeypatch.setattr(TJ.ChunkRunner, "run",
                        lambda self, carry, k: TJ.run_chunk(self._body,
                                                            carry, k))
    eager = train.run(argv)
    assert chip_smoke.same_bits(res["losses"], eager["losses"])
    for a, b in zip(TJ.tree_tensors(res["params"]),
                    TJ.tree_tensors(eager["params"])):
        assert chip_smoke.same_bits(a, b)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-2b", "zamba2-7b",
                                  "deepseek-moe-16b", "xlstm-1.3b"])
def test_cli_names_chunk_runner_for_every_lm_family(arch, capsys):
    """Every family the CLI trains (dense, vlm, hybrid, MoE, xLSTM), at
    reduced size, flat and tree: the CLI names ChunkRunner and its losses
    are finite."""
    for extra in ([], ["--flat-buffer"]):
        res = train.run(LM_CLI + ["--arch", arch, "--steps", "1"] + extra)
        assert "[train] executor: ChunkRunner (its eager program)" \
            in capsys.readouterr().out
        assert res["losses"].shape == (2,)
        assert torch.isfinite(res["losses"]).all()


MESH_CLI = {"model": CLI + ["--flat-buffer", "--channel-model", "dynamic",
                            "--scenario", "iot_dense", "--model-shards",
                            "2"],
            "workers": ["--device", "cpu", "--hidden", "16", "--workers",
                        "16", "--steps", "2", "--dataset-size", "2000",
                        "--flat-buffer", "--channel-model", "dynamic",
                        "--scenario", "mesh_sparse", "--sparse-neighbors",
                        "4", "--eval-every", "0", "--worker-shards", "2"]}


@pytest.mark.parametrize("axis", ["model", "workers"])
def test_cli_executor_over_two_gloo_ranks(axis, tmp_path):
    """The CLI on two gloo ranks, as torchrun starts it: a model-axis mesh
    run and a worker-axis one (a sparse round's) both take ChunkRunner's
    eager program (on cards its graph, over NCCL: chip_smoke's two-card
    phase). Both ranks' losses agree bitwise."""
    import _torch_dist as D
    ranks = D.run_ranks(D.cli_executor, 2, tmp_path, MESH_CLI[axis])
    want = "[train] executor: ChunkRunner (its eager program)"
    for r in ranks:
        assert r["executor"] == [want]
        assert chip_smoke.same_bits(r["losses"], ranks[0]["losses"])
        assert torch.isfinite(r["losses"]).all()


@pytest.mark.parametrize("path", ["flat", "dynamic flat", "tree", "fleet",
                                  "sparse"])
def test_every_chunked_body_is_one_the_runner_takes(path):
    """Every body the chunked CLI builds (the CLI then names ChunkRunner,
    whatever the body) carries no ``uncapturable`` mark and a runner
    takes it: only a body fed by host batches, which --no-scan runs one
    round at a time, is refused (test_runner_refuses_host_batches)."""
    body, _ = chip_smoke.graph_path(path, **SMALL)
    assert getattr(body, "uncapturable", None) is None
    TJ.ChunkRunner(body)


def test_cli_keeps_run_chunk_for_a_sparse_round(capsys, monkeypatch):
    """A sparse round, which the CLI ran through run_chunk (its graph's
    write-back of the [N, d] buffer cost 0.9-2.4% at worker scale, PERF
    §6), takes ChunkRunner now that its rounds write the graph's buffer
    in place: the CLI names it up front, and on the CPU its eager
    program is bitwise the run_chunk loop, chunk for chunk."""
    argv = CLI + ["--flat-buffer", "--channel-model", "dynamic",
                  "--scenario", "mesh_sparse", "--sparse-neighbors", "3"]
    res = train.run(argv)
    assert "[train] executor: ChunkRunner (its eager program)" \
        in capsys.readouterr().out
    assert torch.isfinite(res["losses"]).all()
    monkeypatch.setattr(TJ.ChunkRunner, "run",
                        lambda self, carry, k: TJ.run_chunk(self._body,
                                                            carry, k))
    eager = train.run(argv)
    assert chip_smoke.same_bits(res["losses"], eager["losses"])
    assert chip_smoke.same_bits(res["params"], eager["params"])
