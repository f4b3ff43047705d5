"""End-to-end DWFL training CLI of the port — the reference's
``repro.launch.train``: the paper's MLP (``--arch dwfl-paper``, the
default) or any LM of the registry (``--arch olmo-1b``, ``--reduced`` for
its smoke-scale variant, ``--seq-len`` its windows) on the synthetic
token stream, one window batch a worker, next-token loss; the static
Rayleigh channel with one of the four schemes of the paper's comparison
(dwfl, orthogonal, centralized, gossip), or the dynamic wireless network
(``--channel-model dynamic --scenario ...``: fading, geometry, mobility
and churn, a new channel and W every round, dwfl only), K-round chunks
with on-device batch sampling. Without ``--flat-buffer`` it runs the worker-tree round
(per-leaf noise, the mixing engine); with it the fused dp_mix round on
the flat [N, d] buffer (dwfl and gossip only), as the reference does.
The chunks go through ``core.trajectory.ChunkRunner`` (the reference's
executor): on the card one CUDA graph a chunk length, replayed, the
run's first chunk eager; on the CPU its eager program. Every body the
chunked CLI builds takes it (printed before the run): an LM's round (one
graph of a round), a body over a process-group mesh of any size (its
collectives in the graph), a sparse round's, a worker-axis one's too
(its rounds write the graph's buffer in place). ``--no-scan`` takes each
round's batch from the host batcher instead, one round at a time
(``run_per_round``). A
dynamic run ends with the per-round epsilon trajectory and its
composition under both accountants;
``--total-epsilon`` calibrates sigma every round against a whole-run
budget under ``--accountant``; ``--sparse-neighbors k`` makes each round's
W the capped neighbor list (``net.sparse.SparseW``) and mixes it O(N k),
the worker-scale path (``--scenario mesh_sparse``). ``--replicates R``
(dynamic only) runs R networks in one round (``fleet.FleetEngine``: one
dp_mix launch a flat round for all R) and reports across replicates.

Sharding (``repro_torch.shard``, flat buffer only): ``--model-shards S``
splits the buffer's columns into S windows, one dp_mix call each, on S
ranks when the process group has S (``torchrun --nproc-per-node S``; the
gradient pass trades windows for row blocks by ``all_to_all``, at most
``--max-chunk-cols`` columns a collective), else logically on one
device, as the reference does without S devices; ``--worker-shards S``
(the dynamic sparse round) splits the worker rows over S ranks, which
``torchrun`` must start (NCCL on cards, one rank a card; gloo with
``--device cpu``). ``--remat`` recomputes the forward in the sharded
gradient pass's backward. ``--checkpoint PATH`` writes PATH.npz and
PATH.json after the run (the reference's format: the canonical buffer,
its layout, the generator's state and the network's; or the worker tree).

Observability (``repro_torch.obs``): ``--runlog-dir`` opens a run
directory (manifest.json + events.jsonl, summarized by ``python -m
repro_torch.obs.report`` or the reference's ``repro.obs.report``);
``--telemetry`` (auto: on with a run log) adds the per-round scalars, one
[K, M] host read a chunk; ``--eps-budget`` warns as the composed epsilon
nears and passes a budget; ``--log`` writes the eval records as JSONL.
The chunks run under ``torch.cuda.set_sync_debug_mode("error")`` unless
``--no-transfer-guard``.

    python -m repro_torch.launch.train --arch dwfl-paper --flat-buffer
    python -m repro_torch.launch.train --arch olmo-1b --workers 2 --batch-size 4 --steps 3
    python -m repro_torch.launch.train --arch gemma-2b --reduced --workers 4 --seq-len 128 --device cpu
    python -m repro_torch.launch.train --scheme orthogonal --steps 300
    python -m repro_torch.launch.train --flat-buffer --channel-model dynamic --scenario iot_dense
    python -m repro_torch.launch.train --flat-buffer --channel-model dynamic \
        --scenario mesh_sparse --sparse-neighbors 12 --workers 2048 --steps 4
    python -m repro_torch.launch.train --device cpu --hidden 16 --workers 4 --steps 3
    python -m repro_torch.launch.train --flat-buffer --channel-model dynamic \
        --scenario vehicular --replicates 8 --runlog-dir runs
    python -m repro_torch.launch.train --flat-buffer --model-shards 2 \
        --max-chunk-cols 4096 --checkpoint ckpt/run
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --flat-buffer --channel-model dynamic --scenario mesh_sparse \
        --sparse-neighbors 4 --workers 16 --worker-shards 2

Runs on the card by default and raises without one; ``--device cpu``
runs the plain PyTorch versions of the kernels. Flags of the reference
that this port does not carry yet exit with the ROADMAP item that will
port them. whisper-medium exits: its forward needs the audio frames
(``batch["embeds"]``), which the token stream does not carry, and the
reference's CLI cannot train it either.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core import exchange as X
from repro_torch.core import privacy
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (FederatedBatcher, LMBatcher,
                              classification_dataset, dirichlet_partition,
                              lm_dataset, store_from_batcher)
from repro_torch.kernels.dp_mix import ops as mix_ops
from repro_torch.models import model as M
from repro_torch.net.sparse import SparseW, isolated_count
from repro_torch.runtime import resolve_device

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="dwfl-paper", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch "
                         "(ignored for dwfl-paper)")
    ap.add_argument("--scheme", default="dwfl",
                    choices=["dwfl", "orthogonal", "centralized", "gossip"])
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="per-worker batch size")
    ap.add_argument("--hidden", type=int, default=0,
                    help="override the arch's d_model (0 = default)")
    ap.add_argument("--dataset-size", type=int, default=20000,
                    help="classification dataset size (dwfl-paper)")
    ap.add_argument("--seq-len", type=int, default=128,
                    help="tokens a window (the LMs)")
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--eta", type=float, default=0.4)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--epsilon", type=float, default=1.0,
                    help="per-round target epsilon (0 = fixed sigma)")
    ap.add_argument("--total-epsilon", type=float, default=0.0,
                    help="whole-run (eps, delta) budget over all --steps + 1 "
                         "rounds; sigma is calibrated per round against it "
                         "under --accountant (overrides --epsilon; dynamic "
                         "channel only)")
    ap.add_argument("--accountant", default="composition",
                    choices=["composition", "rdp"],
                    help="privacy ledger: 'composition' = delta-split "
                         "advanced composition; 'rdp' = Renyi-DP moments "
                         "(tighter). Picks the --total-epsilon calibration "
                         "and the report's headline")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--sigma-m", type=float, default=1.0)
    ap.add_argument("--p-dbm", type=float, default=60.0)
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
    ap.add_argument("--channel-model", default="static",
                    choices=["static", "dynamic"],
                    help="static: the paper's one-shot channel; dynamic: a "
                         "new channel and mixing matrix every round "
                         "(repro_torch.net)")
    ap.add_argument("--scenario", default="static_paper",
                    help="network scenario (dynamic only): static_paper, "
                         "iot_dense, vehicular, drone_sparse, mesh_sparse")
    ap.add_argument("--sparse-neighbors", type=int, default=0,
                    help="> 0: degree cap k of the per-round neighbor-list "
                         "mixing matrix (net.sparse.SparseW), mixed O(N k) "
                         "instead of O(N^2) (dynamic only; pair with "
                         "--scenario mesh_sparse)")
    ap.add_argument("--coherence-rounds", type=int, default=0,
                    help="override the scenario's fading block length")
    ap.add_argument("--graph-fallback", action="store_true",
                    help="bridge radius-isolated workers to their nearest "
                         "active neighbor instead of letting them sit out "
                         "the round")
    ap.add_argument("--chunk-rounds", type=int, default=0,
                    help="rounds per chunk (0 = one eval interval)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--flat-buffer", action="store_true",
                    help="train on the persistent flat [N, d] buffer with "
                         "the fused dp_mix round; dwfl/gossip schemes only")
    ap.add_argument("--no-scan", action="store_true",
                    help="one round at a time, each batch drawn by the "
                         "host batcher")
    ap.add_argument("--worker-shards", type=int, default=1,
                    help="shard the flat buffer's worker rows over S ranks "
                         "(repro_torch.shard.worker): each runs the "
                         "gradient pass and the sparse mix of its N/S rows. "
                         "Requires --flat-buffer, --sparse-neighbors > 0, "
                         "the chunked trajectory and S ranks (torchrun "
                         "--nproc-per-node S)")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="shard the flat buffer's columns into S windows "
                         "(repro_torch.shard), one dp_mix call each: on S "
                         "ranks when the process group has S (torchrun), "
                         "else logically on one device. Requires "
                         "--flat-buffer")
    ap.add_argument("--max-chunk-cols", type=int, default=0,
                    help="cap (in columns) on each collective of the "
                         "sharded round's gather-free gradient pass (0 = "
                         "one chunk per leaf x window). Requires "
                         "--model-shards > 1")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the forward in the backward pass of "
                         "the sharded gradient pass (torch.utils."
                         "checkpoint): activation memory for a second "
                         "forward. Requires --model-shards > 1 or "
                         "--worker-shards > 1")
    ap.add_argument("--checkpoint", default=None,
                    help="write a checkpoint here after the run "
                         "(PATH.npz + PATH.json)")
    ap.add_argument("--replicates", type=int, default=1,
                    help="dynamic only: R independent networks in one "
                         "round (repro_torch.fleet); metrics and the "
                         "privacy report as mean and CI across replicates")
    ap.add_argument("--no-transfer-guard", action="store_true",
                    help="run the chunks without torch.cuda."
                         "set_sync_debug_mode('error') (which makes any "
                         "host synchronization in them an error)")
    ap.add_argument("--log", default=None,
                    help="write the eval records as JSONL here")
    ap.add_argument("--runlog-dir", default=None,
                    help="open a run log under this directory "
                         "(manifest.json + events.jsonl; summarize with "
                         "`python -m repro_torch.obs.report`)")
    ap.add_argument("--telemetry", default="auto",
                    choices=["auto", "on", "off"],
                    help="per-round telemetry (loss/grad-norm/consensus/"
                         "SNR/deep-fade/participation/eps), one stacked "
                         "tensor a chunk. auto: on when --runlog-dir is "
                         "set (chunked trajectory only)")
    ap.add_argument("--eps-budget", type=float, default=0.0,
                    help="warn when the composed trajectory epsilon "
                         "approaches (80%%) / exceeds this budget "
                         "(0 = no watchdog; needs telemetry)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if get_arch(args.arch).is_encoder_decoder:
        raise SystemExit(f"--arch {args.arch} cannot train from the token "
                         f"stream: its forward needs the audio frames "
                         f"(batch['embeds']), which the LM batcher does not "
                         f"make; the reference's CLI cannot train it either "
                         f"(ROADMAP A16)")
    if args.sparse_neighbors > 0 and args.channel_model != "dynamic":
        raise SystemExit("--sparse-neighbors requires --channel-model "
                         "dynamic (the sparse neighbor list is the "
                         "per-round unit-disk graph)")
    if args.total_epsilon > 0 and args.channel_model != "dynamic":
        raise SystemExit("--total-epsilon calibrates sigma against the "
                         "realized per-round neighborhoods; it requires "
                         "--channel-model dynamic (static runs: invert "
                         "accounting.sigma_for_total_epsilon by hand)")
    if args.replicates > 1 and args.channel_model != "dynamic":
        raise SystemExit("--replicates requires --channel-model dynamic "
                         "(the static channel is fixed for the whole run; "
                         "there is nothing to batch)")
    if args.telemetry == "on" and args.no_scan:
        raise SystemExit("--telemetry on requires the chunked trajectory "
                         "(telemetry is computed per chunk; drop "
                         "--no-scan)")
    if args.eps_budget > 0 and telemetry_spec(args) is None:
        raise SystemExit("--eps-budget needs telemetry (the composed eps "
                         "comes out of the trajectory's carry); use "
                         "--runlog-dir or --telemetry on")
    return args


def telemetry_spec(args):
    """The run's TelemetrySpec: on with --telemetry on, or auto with a run
    log; never on the per-round (--no-scan) path."""
    if not args.no_scan and (args.telemetry == "on" or (
            args.telemetry == "auto" and args.runlog_dir is not None)):
        return obs.TelemetrySpec()
    return None


def _process_group(device):
    """(the default process group's world size, whether this call started
    it): started from torchrun's environment (WORLD_SIZE > 1) when nothing
    has, NCCL for a card and gloo on the CPU; (1, False) without one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size(), False
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 1, False
    if device.type == "cuda":
        # bind NCCL's communicators to this rank's card
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return dist.get_world_size(), True


def _rank_device(device: str):
    """``--device``, on this rank's card under torchrun (LOCAL_RANK),
    made the current device before anything starts CUDA: NCCL and the
    kernels' launches run on the current device's streams."""
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        dev = resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
        torch.cuda.set_device(dev)
        return dev
    return resolve_device(device)


def isolated_workers(sim, state, seed: int) -> int:
    """Active workers with no neighbor in a first graph draw, from a
    generator of its own (the training stream is untouched). A worker
    isolated by the radius sits out its rounds (listen = 0), which looks
    like slow convergence rather than a connectivity problem. A neighbor
    list is counted as it is (``net.sparse.isolated_count``), without a
    dense W."""
    gen = torch.Generator(device=sim.device)
    gen.manual_seed(seed ^ 0x150)
    _, _, mask, W = sim.round(gen, state)
    if isinstance(W, SparseW):
        return int(isolated_count(W, mask))
    off = (W > 0) & ~torch.eye(W.shape[0], dtype=torch.bool, device=W.device)
    return int(((off.sum(1) == 0) & mask).sum())


def report_dynamic(proto, chunks, runlog=None) -> dict:
    """The per-round epsilon trajectory of the realized channels and Ws,
    printed as the reference prints it."""
    traj = TJ.concat_chunks(chunks)
    rep = P.epsilon_report(proto, traj["chan"], Ws=traj["W"])
    eps = rep["epsilon_per_round"]
    print(f"[train] per-round eps over {rep['rounds']} rounds: "
          f"min={eps.min():.3g} mean={rep['epsilon_mean']:.3g} "
          f"max={rep['epsilon_worst']:.3g}  "
          f"composed(eps,delta)=({rep['epsilon_trajectory_composed']:.3g}, "
          f"{rep['delta_trajectory_composed']:.2g})")
    print(f"[train] accountant[{rep['accountant']}]: "
          f"rdp={rep['epsilon_rdp']:.3g} vs "
          f"advanced={rep['epsilon_advanced']:.3g} "
          f"-> quoting {rep['epsilon_total']:.3g} "
          f"(delta={rep['delta_total']:.2g}, "
          f"gap {rep['accountant_gap']:.2g}x, "
          f"order={rep['rdp_order']:.3g})")
    if runlog is not None:
        runlog.event("epsilon_report", rounds=rep["rounds"],
                     eps_worst_round=rep["epsilon_worst"],
                     eps_mean_round=rep["epsilon_mean"],
                     eps_composed=rep["epsilon_trajectory_composed"],
                     delta_composed=rep["delta_trajectory_composed"],
                     eps_rdp=rep["epsilon_rdp"],
                     eps_total=rep["epsilon_total"],
                     delta_total=rep["delta_total"],
                     accountant_gap=rep["accountant_gap"],
                     rdp_order=rep["rdp_order"],
                     accountant=rep["accountant"],
                     saturated=rep["saturated"])
    return rep


def report_fleet(proto, chunks, runlog=None) -> dict:
    """The replicated privacy report over every replicate's realized
    trajectory ([R, T, N] budgets in one evaluation), printed as the
    reference prints it."""
    from repro_torch.fleet import fleet_epsilon_report
    traj = TJ.replicate_major(TJ.concat_chunks(chunks))
    rep = fleet_epsilon_report(proto, traj["chan"], traj["W"])
    print(f"[train] eps over {rep['rounds']} rounds x "
          f"{rep['replicates']} replicates: worst/round="
          f"{rep['epsilon_worst']:.3g} composed="
          f"{rep['epsilon_composed_mean']:.3g}"
          f"±{rep['epsilon_composed_ci95']:.2g} "
          f"(delta={rep['delta_composed']:.2g})")
    print(f"[train] accountant[{rep['accountant']}]: "
          f"rdp={rep['epsilon_rdp_mean']:.3g} vs "
          f"advanced={rep['epsilon_advanced_mean']:.3g} "
          f"-> quoting {rep['epsilon_total_mean']:.3g}"
          f"±{rep['epsilon_total_ci95']:.2g} "
          f"(delta={rep['delta_total']:.2g}, "
          f"gap {rep['accountant_gap']:.2g}x)")
    if runlog is not None:
        runlog.event("epsilon_report", rounds=rep["rounds"],
                     replicates=rep["replicates"],
                     eps_worst_round=rep["epsilon_worst"],
                     eps_composed_mean=rep["epsilon_composed_mean"],
                     eps_composed_ci95=rep["epsilon_composed_ci95"],
                     delta_composed=rep["delta_composed"],
                     eps_rdp_mean=rep["epsilon_rdp_mean"],
                     eps_total_mean=rep["epsilon_total_mean"],
                     eps_total_ci95=rep["epsilon_total_ci95"],
                     delta_total=rep["delta_total"],
                     accountant_gap=rep["accountant_gap"],
                     accountant=rep["accountant"],
                     saturated=rep["saturated"])
    return rep


def _log_chunk(runlog, tele, out, t0: int) -> None:
    """The chunk's telemetry rows into the run log: ONE host read of the
    stacked [K, M] ([K, R, M]: the mean across replicates) rows."""
    rows = out["telemetry"].cpu().numpy()
    if rows.ndim == 3:
        rows = rows.mean(axis=1)
    for i, row in enumerate(rows):
        runlog.round_metrics(t0 + i, **{f: float(v) for f, v
                                        in zip(tele.fields, row)})


def _quote_eps(args, proto, carry, out, tele, t, do_eval, eps_dog, runlog):
    """The composed budget so far from ``carry.eps`` (the worst replicate
    binds): fed to the budget watchdog, and at evals into the run log."""
    m = carry.eps.cpu().numpy()
    e_c, d_c = privacy.compose_from_moments(m, proto.delta)
    e_worst = float(np.max(e_c))
    e_rdp = None
    if m.shape[-1] > 4:
        e_r, _ = privacy.compose_from_moments(m, proto.delta,
                                              accountant="rdp")
        e_rdp = float(np.max(e_r))
    e_track = (e_rdp if args.accountant == "rdp" and e_rdp is not None
               else e_worst)
    if eps_dog is not None:
        eps_dog.check(e_track, step=t - 1)
    if do_eval and runlog is not None:
        extra = ({"eps_rdp": e_rdp, "accountant": args.accountant}
                 if e_rdp is not None else {})
        col = tele.fields.index("epsilon")
        runlog.epsilon(step=t - 1, eps_composed=e_worst,
                       delta_composed=float(np.max(d_c)),
                       rounds=int(np.max(m[..., 3])),
                       eps_round=float(out["telemetry"][-1, ..., col].max()),
                       **extra)


def refuse_past_counter_limit(cfg, n_workers: int) -> None:
    """C2, before anything is allocated: a flat buffer whose N
    roundup(d, 128) noise counters pass 2^31 exits (the uint32 counters
    would wrap; the reference's would, silently). d comes from the
    parameters' shapes alone (an init on the meta device)."""
    d = M.count_params(M.init_params(torch.Generator(), cfg, "meta"))
    try:
        mix_ops.check_counter_limit(n_workers, d)
    except ValueError as e:
        raise SystemExit(f"--flat-buffer at N = {n_workers}, d = {d}: {e} "
                         f"(ROADMAP C2)") from None


def model_config(args):
    """The run's ModelConfig: the arch, its reduced() variant with
    --reduced (dwfl-paper ignores the flag, as the reference does), its
    d_model replaced by --hidden."""
    cfg = get_arch(args.arch)
    if args.reduced and args.arch != "dwfl-paper":
        cfg = cfg.reduced()
    if args.hidden > 0:
        cfg = dataclasses.replace(cfg, d_model=args.hidden)
    return cfg


def protocol_config(args) -> P.ProtocolConfig:
    """The run's ProtocolConfig, from its parsed arguments."""
    total = args.total_epsilon > 0
    return P.ProtocolConfig(
        scheme=args.scheme, n_workers=args.workers, gamma=args.gamma,
        eta=args.eta, clip=args.clip, sigma=args.sigma, sigma_m=args.sigma_m,
        p_dbm=args.p_dbm, seed=args.seed,
        target_epsilon=0.0 if total else args.epsilon,
        flat_buffer=args.flat_buffer, channel_model=args.channel_model,
        scenario=args.scenario, coherence_rounds=args.coherence_rounds,
        graph_fallback=args.graph_fallback,
        sparse_neighbors=args.sparse_neighbors, accountant=args.accountant,
        target_total_epsilon=args.total_epsilon,
        horizon=args.steps + 1 if total else 0, replicates=args.replicates)


def run(argv=None) -> dict:
    """Train as ``main`` does and return what the run measured: per-round
    losses [T] (CPU tensor; the fleet's [T, R]), the eval records, the
    loop's wall seconds, the final parameters (the flat buffer with
    ``--flat-buffer``, else the worker tree; the fleet's [R, ...]), on a
    limited-range network the active workers isolated in the first graph
    draw, the per-round telemetry rows ([T, M]; the fleet's [T, R, M])
    and the carry's epsilon moments when telemetry is on, and the run
    directory of a run log."""
    args = parse_args(argv)
    dev = _rank_device(args.device)
    cfg = model_config(args)
    W = args.workers
    total = args.total_epsilon > 0
    proto = protocol_config(args)
    if total:
        print(f"[train] total budget: eps={args.total_epsilon} "
              f"delta={proto.delta} over {args.steps + 1} rounds "
              f"(accountant={args.accountant})")
    if proto.flat_buffer and args.scheme not in ("dwfl", "gossip"):
        raise SystemExit("--flat-buffer supports the mixing-family schemes "
                         "only (dwfl/gossip)")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[train] device: {dev} ({name})")
    tele = telemetry_spec(args)
    n_shards = max(1, args.model_shards)
    if n_shards > 1 and not proto.flat_buffer:
        raise SystemExit("--model-shards requires --flat-buffer (only the "
                         "persistent flat buffer has a model axis to shard)")
    max_chunk_cols = args.max_chunk_cols if args.max_chunk_cols > 0 else None
    if max_chunk_cols is not None and n_shards <= 1:
        raise SystemExit("--max-chunk-cols caps the sharded round's "
                         "collective chunks; it requires --model-shards > 1")
    if args.remat and n_shards <= 1 and args.worker_shards <= 1:
        raise SystemExit("--remat rematerializes the sharded grad block; "
                         "it requires --model-shards > 1 or "
                         "--worker-shards > 1")
    from repro_torch.launch import mesh as mesh_lib
    import torch.distributed as dist
    if args.worker_shards > 1:
        if not (proto.flat_buffer and proto.sparse_neighbors > 0
                and args.channel_model == "dynamic"):
            raise SystemExit("--worker-shards requires --flat-buffer and "
                             "--sparse-neighbors > 0 (only the sparse "
                             "neighbor-list round has a worker-sharded "
                             "lowering)")
        if n_shards > 1 or args.replicates > 1 or args.no_scan:
            raise SystemExit("--worker-shards composes with neither "
                             "--model-shards, --replicates nor --no-scan "
                             "yet")
        if W % args.worker_shards != 0:
            raise SystemExit(f"--workers {W} must divide evenly over "
                             f"--worker-shards {args.worker_shards}")
    # owned: a process group this run started (and stops)
    world, owned = (_process_group(dev)
                    if args.worker_shards > 1 or n_shards > 1 else (1, False))
    worker_mesh = shard_mesh = None
    if args.worker_shards > 1:
        if world != args.worker_shards:
            raise SystemExit(f"--worker-shards {args.worker_shards} needs "
                             f"that many ranks; have {world} (torchrun "
                             f"--nproc-per-node {args.worker_shards})")
        worker_mesh = mesh_lib.make_worker_mesh(args.worker_shards,
                                                device=dev)
        print(f"[train] worker shards: {args.worker_shards} x "
              f"{W // args.worker_shards} rows on a 'workers' mesh")
    elif n_shards > 1 and world == n_shards:
        # fleet: a 2-D (replicas=1, model=S) mesh
        shard_mesh = mesh_lib.make_shard_mesh(
            n_shards, n_replicas=1 if args.replicates > 1 else None,
            device=dev)
    mesh = worker_mesh if worker_mesh is not None else shard_mesh
    # on a mesh, rank 0 alone writes the run log; every rank computes the
    # telemetry (its consensus is a collective) and composes the same
    # epsilon, so an --eps-budget warning fires on the same round on all
    lead_rank = mesh is None or dist.get_rank() == 0
    runlog = None
    if args.runlog_dir is not None and lead_rank:
        runlog = obs.RunLog.open_under(
            args.runlog_dir, kind="train",
            config={"args": vars(args),
                    "protocol": dataclasses.asdict(proto)},
            seed=args.seed, argv=argv,
            extra={"telemetry": list(tele.fields) if tele else None})
        print(f"[train] run log -> {runlog.dir}")
    sim, fleet, rep = None, None, None
    if args.replicates > 1:
        from repro_torch.fleet import FleetEngine
        fleet = FleetEngine(proto, device=dev)
        sim = fleet.sim
        print(f"[train] {args.arch} scheme={args.scheme} N={W} "
              f"dynamic scenario={args.scenario} R={args.replicates} "
              f"replicates/round "
              f"coherence={sim.scenario.fading.coherence_rounds} rounds")
    elif args.channel_model == "dynamic":
        sim = proto.simulator(dev)
        print(f"[train] {args.arch} scheme={args.scheme} N={W} "
              f"dynamic scenario={args.scenario} "
              f"coherence={sim.scenario.fading.coherence_rounds} rounds")
    else:
        rep = P.epsilon_report(proto, proto.channel())
        print(f"[train] {args.arch} scheme={args.scheme} N={W} "
              f"eps={rep['epsilon_worst']:.3g}/round "
              f"sigma={rep['sigma']:.3g} (orthogonal would be "
              f"eps={rep['epsilon_orthogonal_worst']:.3g})")

    if cfg.family == "mlp":
        x, y = classification_dataset(args.dataset_size, seed=args.seed)
        parts = dirichlet_partition(y, W, alpha=args.dirichlet_alpha,
                                    seed=args.seed)
        batcher = FederatedBatcher(x, y, parts, args.batch_size,
                                   seed=args.seed)
    else:
        toks = lm_dataset(W * 200_000, cfg.vocab_size, seed=args.seed)
        batcher = LMBatcher(toks, W, args.batch_size, args.seq_len,
                            seed=args.seed)

    if proto.flat_buffer:
        refuse_past_counter_limit(cfg, W)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    if fleet is not None:
        wp = fleet.init_worker_params(gen, cfg)
        lead = 2
    else:
        wp = P.init_worker_params(gen, cfg, W, dev)
        lead = 1
    layout = X.make_flat_spec(
        wp, lead_axes=lead, n_shards=n_shards if proto.flat_buffer else None,
        max_chunk_cols=max_chunk_cols)
    spec = layout if proto.flat_buffer else None
    if layout.layout is not None:
        where = (f"{n_shards} ranks" if shard_mesh is not None else
                 "1 device (logical; torchrun --nproc-per-node "
                 f"{n_shards} for a mesh)")
        plan = layout.chunk_plan
        print(f"[train] model shards: {n_shards} x "
              f"{layout.layout.shard_width} cols ({layout.width} padded, "
              f"d={layout.d}) on {where}; grad-pass chunk plan: "
              f"{len(plan.chunks)} chunks, {len(plan.exec_segments())} "
              f"collective segments"
              + (f", cap {max_chunk_cols} cols" if max_chunk_cols
                 else " (unbounded)"))
    print(f"[train] params/worker: {layout.d / 1e6:.2f}M"
          + (" (flat dp_mix buffer)" if proto.flat_buffer else ""))
    net, iso = None, None
    if fleet is not None:
        net = fleet.init(gen)
    elif sim is not None:
        net = sim.init(gen)
        if sim.sparse_k > 0 or sim.scenario.geometry.comm_radius > 0:
            iso = isolated_workers(sim, net, args.seed)
            if iso:
                msg = (f"{iso}/{W} active workers isolated in the first "
                       f"graph draw (comm_radius="
                       f"{sim.scenario.geometry.comm_radius:g})"
                       + ("" if args.graph_fallback
                          else " — consider --graph-fallback"))
                if runlog is not None:
                    runlog.warn(msg, isolated=iso, n_workers=W,
                                graph_fallback=args.graph_fallback)
                print(f"[train] WARNING: {msg}")

    # the eval batch, pinned once before the loop: the classifier's fixed
    # per-worker slice; an LM's one draw of the batcher (the fleet's R
    # draws), taken before any training batch, as the reference takes it
    evaluate = P.make_eval_fn(cfg)
    eval_batch = None
    if args.eval_every > 0:
        R = 1 if fleet is None else fleet.replicates
        if cfg.family == "mlp":
            eval_batch = {k: torch.as_tensor(v, device=dev)
                          for k, v in batcher.full(256).items()}
            if fleet is not None:
                eval_batch = {k: v.expand((R,) + v.shape)
                              for k, v in eval_batch.items()}
        else:
            draws = [batcher.next() for _ in range(R)]
            eval_batch = {k: torch.as_tensor(
                draws[0][k] if fleet is None
                else np.stack([d[k] for d in draws]), device=dev)
                for k in draws[0]}
        if fleet is not None:
            from repro_torch.fleet import fleet_eval
            one = evaluate
            evaluate = lambda params, batch: tuple(
                v.mean() for v in fleet_eval(one, params, batch))
    if args.no_scan:
        source = TJ.HostBatches(batcher, dev)
        chunk = 1
        print("[train] per-round loop: host batches")
    else:
        source = store_from_batcher(batcher, dev)
        coher = (sim.scenario.fading.coherence_rounds
                 if sim is not None else None)
        chunk = (args.chunk_rounds if args.chunk_rounds > 0
                 else TJ.auto_chunk(args.eval_every, coher))
        print(f"[train] chunked trajectory: chunk={chunk} rounds"
              + (f", telemetry: {','.join(tele.fields)}" if tele else ""))
    body = TJ.make_round_body(cfg, proto, source, spec, dev,
                              sim=None if fleet is not None else sim,
                              fleet=fleet, telemetry=tele,
                              shard_mesh=shard_mesh, worker_mesh=worker_mesh,
                              remat=args.remat)
    guard = lambda: obs.no_implicit_transfers(not args.no_transfer_guard,
                                              dev)
    # the executor, chosen here and never changed by what a chunk does
    runner = None
    if args.no_scan:
        # the guard holds each round; the per-round executor's copy of the
        # round's metrics to the host stays outside it
        def guarded(carry):
            with guard():
                return body(carry)

        run_rounds = lambda carry, n: TJ.run_per_round(guarded, carry, n)
        print("[train] executor: run_per_round (one round at a time)")
    else:
        # the hot path, a whole chunk: it touches device tensors only
        runner = TJ.ChunkRunner(body)

        def run_rounds(carry, n):
            with guard():
                return runner.run(carry, n)

        graph = ("one CUDA graph of a round, replayed a chunk's rounds"
                 if body.round_graph else "one CUDA graph a chunk length")
        if body.writes_into:
            graph += ", the rounds writing its buffer in place"
        print("[train] executor: ChunkRunner ("
              + (f"{graph}, the first chunk eager)" if dev.type == "cuda"
                 else "its eager program)"))

    eps0 = (obs.init_eps_moments(
                fleet.replicates if fleet is not None else None, device=dev)
            if tele is not None and tele.epsilon else None)
    params0 = spec.flatten(wp) if spec is not None else wp
    if shard_mesh is not None:
        from repro_torch.shard.round import local_window
        params0 = local_window(params0, spec, shard_mesh)
        if fleet is not None:
            params0 = params0[fleet.replicate_slice(shard_mesh)]
    elif worker_mesh is not None:
        from repro_torch.shard.worker import local_rows
        params0 = local_rows(params0, worker_mesh)
    carry = TJ.TrajCarry(gen, params0, net, eps0)
    del wp, params0  # the flat path trains on its copy: one [N, d] less held

    def whole(params):
        """The whole buffer from this rank's part (a collective)."""
        if shard_mesh is not None:
            from repro_torch.shard.round import full_buffer
            return full_buffer(params, spec, shard_mesh)
        if worker_mesh is not None:
            from repro_torch.shard.worker import full_rows
            return full_rows(params, worker_mesh)
        return params
    eps_dog = (obs.EpsilonBudgetWatchdog(
                   args.eps_budget,
                   on_warn=runlog.warn if runlog is not None else
                   (lambda msg, **kw: print(f"[train] WARNING: {msg}")))
               if args.eps_budget > 0 else None)
    retrace_dog = obs.RetraceWatchdog(obs.guard.LibraryBuilds(),
                                      runlog=runlog, label="kernels")
    # a length captured twice raises in the runner; this records each
    # capture in the run log
    chunk_dog = (obs.RetraceWatchdog(runner, runlog=runlog, label="chunk")
                 if runner is not None else None)
    logf = open(args.log, "w") if args.log else None
    losses, evals, chunks, rows = [], [], [], []
    t0 = time.time()
    t = 0
    try:
        for n, do_eval in TJ.plan_chunks(args.steps + 1, chunk,
                                         args.eval_every):
            carry, out = run_rounds(carry, n)
            t += n
            losses.append(out["metrics"]["loss"])
            if "chan" in out:
                chunks.append(out)
            if tele is not None:
                rows.append(out["telemetry"])
                if runlog is not None:
                    _log_chunk(runlog, tele, out, t - n)
            retrace_dog.check(step=t - 1)
            if chunk_dog is not None:
                chunk_dog.check(step=t - 1)
            if carry.eps is not None and (do_eval or eps_dog is not None):
                _quote_eps(args, proto, carry, out, tele, t, do_eval,
                           eps_dog, runlog)
            if do_eval:
                params = (spec.unravel(whole(carry.params))
                          if spec is not None else carry.params)
                ev_loss, ev_acc = evaluate(params, eval_batch)
                rec = {"step": t - 1,
                       "loss": float(out["metrics"]["loss"][-1].mean()),
                       "eval_loss": float(ev_loss),
                       "eval_acc": float(ev_acc),
                       "grad_norm": float(
                           out["metrics"]["grad_norm"][-1].mean()),
                       "wall_s": round(time.time() - t0, 1)}
                evals.append(rec)
                print(f"[train] step={rec['step']:5d} "
                      f"loss={rec['loss']:.4f} "
                      f"eval={rec['eval_loss']:.4f} "
                      f"acc={rec['eval_acc']:.3f} ({rec['wall_s']}s)")
                if logf:
                    logf.write(json.dumps(rec) + "\n")
                    logf.flush()
                if runlog is not None:
                    runlog.eval_metrics(**rec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.time() - t0
        if fleet is not None:
            rep = report_fleet(proto, chunks, runlog)
        elif sim is not None:
            rep = report_dynamic(proto, chunks, runlog)
        if args.checkpoint:
            # after the loop, outside the sync guard: the copy to the host
            # is the checkpoint's
            final = whole(carry.params) if spec is not None else None
            if lead_rank:
                save_checkpoint(args, proto, spec, carry, final, rep, chunks)
                print(f"[train] checkpoint -> {args.checkpoint}")
                if runlog is not None:
                    runlog.checkpoint(args.checkpoint, step=args.steps)
    except BaseException:
        if runlog is not None:
            runlog.close("error")
        raise
    finally:
        if logf:
            logf.close()
        if runner is not None:
            # its graphs before the group: NCCL's destroy waits for them
            runner.close()
        if owned:
            dist.destroy_process_group()
    if runlog is not None:
        # a run whose manifest still says "open" crashed before this line
        runlog.close("ok", steps=args.steps)
        print(f"[train] run log closed: {runlog.dir} "
              f"({runlog.n_events} events, {runlog.n_warnings} warnings) — "
              f"summarize with `python -m repro_torch.obs.report "
              f"{runlog.dir}`")
    return {"losses": torch.cat([l.cpu() for l in losses]), "evals": evals,
            "rounds": t, "seconds": seconds, "params": carry.params,
            "epsilon_worst": rep["epsilon_worst"], "epsilon_report": rep,
            "isolated_workers": iso,
            "telemetry": (torch.cat([r.cpu() for r in rows])
                          if rows else None),
            "eps_moments": (None if carry.eps is None
                            else carry.eps.cpu()),
            "runlog_dir": None if runlog is None else runlog.dir}


def save_checkpoint(args, proto, spec, carry, flat, rep, chunks) -> None:
    """The reference's end-of-run checkpoint: with the flat buffer
    (``flat``, the whole of it) ``checkpoint.save_flat`` with the layout and
    the trajectory's state (the generator's and the network's: a bitwise
    resume, ``checkpoint.resume_carry``); else the worker tree."""
    from repro_torch import checkpoint
    meta = {"arch": args.arch, "scheme": args.scheme,
            "epsilon": rep["epsilon_worst"]}
    if proto.sparse_neighbors > 0:
        # the padded neighbor-list contract of the run's Ws
        meta["sparse_neighbors"] = proto.sparse_neighbors
        if chunks and isinstance(chunks[-1]["W"], SparseW):
            meta["sparse_w"] = chunks[-1]["W"].layout_meta()
    if spec is not None:
        checkpoint.save_flat(args.checkpoint, flat, spec, step=args.steps,
                             state=checkpoint.trajectory_state(carry),
                             metadata=meta)
    else:
        checkpoint.save(args.checkpoint, carry.params, step=args.steps,
                        metadata=meta)


def main(argv=None) -> int:
    if int(os.environ.get("RANK", "0")) != 0:
        # one rank speaks for a torchrun job
        with contextlib.redirect_stdout(io.StringIO()):
            run(argv)
    else:
        run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
