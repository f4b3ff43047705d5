"""ChunkRunner's two capture designs on the card: one CUDA graph a chunk
length against one round's graph replayed k times a chunk.

    python3 scripts/port_chunk_graph_designs.py [PART ...]

PART is any of ``kround``, ``roundheld``, ``turns``, ``mesh``, ``lmmem``
(all when none is given):

* ``kround``: the chunk-length graph of olmo-1b's reduced tree and flat
  round and xlstm-1.3b's reduced tree round (N = 3, batch 2, sequence
  32), held against ``run_chunk`` by chip_smoke's ``graph_held`` and
  ``check_held`` (two eager runs, also held to each other);
* ``roundheld``: each of chip_smoke's GRAPH_PATHS as one round's graph
  (``body.round_graph`` set), held the same way;
* ``turns``: ms a round of each path under the chunk-length graph and
  the round graph, in turns (chunk, round, round, chunk), each turn a new
  runner with two untimed chunks, then 10 chunks of 10 rounds (the
  sparse round at N = SPARSE_N: 2 of 2), host clock ending in a
  synchronize; peak allocated and reserved memory of each turn;
* ``mesh``: the model-axis round with and without telemetry and the
  fleet on a (1, 1) mesh (GRAPH_MESH_PATHS), on a one-rank NCCL group,
  as one round's graph held, then both designs in turns;
* ``lmmem``: chip_smoke's ``graph_turns`` of olmo-1b's full-depth tree
  round (N = 2): graph against eager, peak memory and the GiB reserved
  at each turn's start.

Each result is printed as one ``[designs]`` JSON line, after the card's
name and power limit as nvidia-smi gives them. Needs a card; runs from
the repo's root.
"""
import functools
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PARTS = ("kround", "roundheld", "turns", "mesh", "lmmem")


def item(name, fn):
    """Run ``fn`` and print its record (or its failure) as one line."""
    import torch
    t = time.time()
    try:
        rec = fn()
        print(f"[designs] {name} OK {time.time() - t:.1f}s "
              f"{json.dumps(rec, default=str)}", flush=True)
    except BaseException as e:    # noqa: BLE001 (a failed check is a result)
        print(f"[designs] {name} FAILED {time.time() - t:.1f}s "
              f"{type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
    gc.collect()
    torch.cuda.empty_cache()


def forced(build, round_graph: bool):
    """``build`` with its body's design set: one round's graph or one
    graph a chunk length."""
    def made(path, **kw):
        body, carry = build(path, **kw)
        body.round_graph = round_graph
        return body, carry
    return made


def held(path, build, K, kernels, eager_runs=1, **kw):
    rec = cs.graph_held(path, build, K, eager_runs=eager_runs, **kw)
    rec["differ"] = rec["differ"][:8]
    try:
        cs.check_held(rec, tuple(kernels))
        rec["check"] = "pass"
    except SystemExit:
        rec["check"] = "FAIL"
    return rec


def design_turns(path, build, K, chunks, **kw):
    """ms a round under the chunk-length graph against the round graph,
    in turns (chunk, round, round, chunk)."""
    import torch
    from repro_torch.core import trajectory as TJ
    body, carry = build(path, **kw)
    rate = {"chunk": [], "round": []}
    peak = {"chunk": [], "round": []}
    for turn in ("chunk", "round", "round", "chunk"):
        gc.collect()
        torch.cuda.empty_cache()
        body.round_graph = turn == "round"
        runner = TJ.ChunkRunner(body)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            carry, _ = runner.run(carry, K)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(chunks):
            carry, _ = runner.run(carry, K)
        torch.cuda.synchronize()
        rate[turn].append(chunks * K / (time.perf_counter() - t))
        peak[turn].append((torch.cuda.max_memory_allocated() / 2**30,
                           torch.cuda.max_memory_reserved() / 2**30))
        del runner
    del body, carry
    return {"path": path, "K": K, "chunks": chunks, "rounds_per_s": rate,
            "ms_a_round": {k: [1e3 / r for r in v] for k, v in rate.items()},
            "round_over_chunk": [r / c for r, c in
                                 zip(rate["round"], reversed(rate["chunk"]))],
            "peak_gib": peak}


def main(argv) -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.dp_mix import ops
    from repro_torch.kernels.dp_perturb import ops as dp_perturb_ops
    parts = argv or list(PARTS)
    if not torch.cuda.is_available() or set(parts) - set(PARTS):
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), torch.__version__, flush=True)
    build.build_all([ops.LIBRARY, dp_perturb_ops.LIBRARY])
    kernels = cs.GRAPH_KERNELS
    if "kround" in parts:
        for arch, path in (("olmo-1b", "lm tree"), ("olmo-1b", "lm flat"),
                           ("xlstm-1.3b", "lm tree")):
            item(f"kround {arch} {path} reduced", functools.partial(
                held, path, forced(cs.lm_graph_path, False), 2,
                kernels[path], eager_runs=2, arch=arch, reduced=True, N=3,
                batch=2, seq=32))
    if "roundheld" in parts:
        for path in cs.GRAPH_PATHS:
            kw = {"N": cs.SPARSE_N} if path == "sparse" else {}
            K = cs.GRAPH_SPARSE_K if path == "sparse" else cs.GRAPH_K
            item(f"roundheld {path}", functools.partial(
                held, path, forced(cs.graph_path, True), K, kernels[path],
                **kw))
    if "turns" in parts:
        for path in ("flat", "flat telemetry", "dynamic flat", "tree",
                     "dynamic tree", "fleet"):
            item(f"design turns {path}", functools.partial(
                design_turns, path, cs.graph_path, cs.GRAPH_TURN_K, 10))
        item("design turns sparse", functools.partial(
            design_turns, "sparse", cs.graph_path, cs.GRAPH_SPARSE_K, 2,
            N=cs.SPARSE_N))
    if "mesh" in parts:
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_shard_mesh
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{cs._free_port()}", rank=0, world_size=1)
        mesh = make_shard_mesh(1, device="cuda")
        fleet_mesh = make_shard_mesh(1, n_replicas=1, device="cuda")
        for path in cs.GRAPH_MESH_PATHS:
            m = fleet_mesh if path == "mesh fleet" else mesh
            made = functools.partial(cs.mesh_graph_path, mesh=m)
            item(f"roundheld {path}", functools.partial(
                held, path, forced(made, True), cs.GRAPH_K, kernels[path],
                eager_runs=2))
            item(f"design turns {path}", functools.partial(
                design_turns, path, made, cs.GRAPH_TURN_K, 10))
        dist.destroy_process_group()
    if "lmmem" in parts:
        item("lm tree full turns", functools.partial(
            cs.graph_turns, "lm tree", cs.GRAPH_LM_K,
            cs.GRAPH_LM_TURN_CHUNKS, build=cs.lm_graph_path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
