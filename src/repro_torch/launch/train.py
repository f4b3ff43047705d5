"""End-to-end DWFL training CLI of the port — the reference's
``repro.launch.train`` for the paper's MLP: the static Rayleigh channel
with one of the four schemes of the paper's comparison (dwfl, orthogonal,
centralized, gossip), or the dynamic wireless network (``--channel-model
dynamic --scenario ...``: fading, geometry, mobility and churn, a new
channel and W every round, dwfl only), K-round chunks with on-device
batch sampling. Without ``--flat-buffer`` it runs the worker-tree round
(per-leaf noise, the mixing engine); with it the fused dp_mix round on
the flat [N, d] buffer (dwfl and gossip only), as the reference does.
``--no-scan`` takes each round's batch from the host batcher instead, one
round at a time. A dynamic run ends with the per-round epsilon
trajectory and its composition under both accountants;
``--total-epsilon`` calibrates sigma every round against a whole-run
budget under ``--accountant``; ``--sparse-neighbors k`` makes each round's
W the capped neighbor list (``net.sparse.SparseW``) and mixes it O(N k),
the worker-scale path (``--scenario mesh_sparse``). ``--replicates R``
(dynamic only) runs R networks in one round (``fleet.FleetEngine``: one
dp_mix launch a flat round for all R) and reports across replicates.

Observability (``repro_torch.obs``): ``--runlog-dir`` opens a run
directory (manifest.json + events.jsonl, summarized by ``python -m
repro_torch.obs.report`` or the reference's ``repro.obs.report``);
``--telemetry`` (auto: on with a run log) adds the per-round scalars, one
[K, M] host read a chunk; ``--eps-budget`` warns as the composed epsilon
nears and passes a budget; ``--log`` writes the eval records as JSONL.
The chunks run under ``torch.cuda.set_sync_debug_mode("error")`` unless
``--no-transfer-guard``.

    python -m repro_torch.launch.train --arch dwfl-paper --flat-buffer
    python -m repro_torch.launch.train --scheme orthogonal --steps 300
    python -m repro_torch.launch.train --flat-buffer --channel-model dynamic --scenario iot_dense
    python -m repro_torch.launch.train --flat-buffer --channel-model dynamic \
        --scenario mesh_sparse --sparse-neighbors 12 --workers 2048 --steps 4
    python -m repro_torch.launch.train --device cpu --hidden 16 --workers 4 --steps 3
    python -m repro_torch.launch.train --flat-buffer --channel-model dynamic \
        --scenario vehicular --replicates 8 --runlog-dir runs

Runs on the card by default and raises without one; ``--device cpu``
runs the plain PyTorch versions of the kernels. Flags of the reference
that this port does not carry yet exit with the ROADMAP item that will
port them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import privacy
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, FederatedBatcher,
                              classification_dataset, dirichlet_partition)
from repro_torch.net.sparse import SparseW, isolated_count
from repro_torch.runtime import resolve_device

# reference flags not ported yet -> the ROADMAP item that ports them
NOT_PORTED = {
    "--reduced": "A15", "--seq-len": "A15",
    "--worker-shards": "A14", "--model-shards": "A14",
    "--max-chunk-cols": "A14", "--remat": "A14", "--checkpoint": "A13",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="dwfl-paper")
    ap.add_argument("--scheme", default="dwfl",
                    choices=["dwfl", "orthogonal", "centralized", "gossip"])
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="per-worker batch size")
    ap.add_argument("--hidden", type=int, default=0,
                    help="override the arch's hidden width (0 = default)")
    ap.add_argument("--dataset-size", type=int, default=20000)
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
    args, rest = ap.parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED:
            raise SystemExit(f"{flag} is not ported to repro_torch yet "
                             f"(ROADMAP {NOT_PORTED[flag]})")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.arch != "dwfl-paper":
        raise SystemExit(f"--arch {args.arch} is not ported to repro_torch "
                         f"yet (ROADMAP A15); only dwfl-paper is")
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
    if args.replicates > 1 and args.sparse_neighbors > 0:
        raise SystemExit("--replicates with --sparse-neighbors is not "
                         "ported to repro_torch yet (ROADMAP A20)")
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
    dev = resolve_device(args.device)
    cfg = DWFL_PAPER
    if args.hidden > 0:
        cfg = dataclasses.replace(cfg, d_model=args.hidden)
    W = args.workers
    total = args.total_epsilon > 0
    proto = P.ProtocolConfig(
        scheme=args.scheme, n_workers=W, gamma=args.gamma, eta=args.eta,
        clip=args.clip, sigma=args.sigma, sigma_m=args.sigma_m,
        p_dbm=args.p_dbm, seed=args.seed,
        target_epsilon=0.0 if total else args.epsilon,
        flat_buffer=args.flat_buffer, channel_model=args.channel_model,
        scenario=args.scenario, coherence_rounds=args.coherence_rounds,
        graph_fallback=args.graph_fallback,
        sparse_neighbors=args.sparse_neighbors, accountant=args.accountant,
        target_total_epsilon=args.total_epsilon,
        horizon=args.steps + 1 if total else 0, replicates=args.replicates)
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
    runlog = None
    if args.runlog_dir is not None:
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

    x, y = classification_dataset(args.dataset_size, seed=args.seed)
    parts = dirichlet_partition(y, W, alpha=args.dirichlet_alpha,
                                seed=args.seed)
    batcher = FederatedBatcher(x, y, parts, args.batch_size, seed=args.seed)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    if fleet is not None:
        wp = fleet.init_worker_params(gen, cfg)
        layout = X.FlatSpec(wp, lead_axes=2)
    else:
        wp = P.init_worker_params(gen, cfg, W, dev)
        layout = X.FlatSpec(wp)
    spec = layout if proto.flat_buffer else None
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

    evaluate = P.make_eval_fn(cfg)
    eval_batch = None
    if args.eval_every > 0:
        eval_batch = {k: torch.as_tensor(v, device=dev)
                      for k, v in batcher.full(256).items()}
        if fleet is not None:
            from repro_torch.fleet import fleet_eval
            one = evaluate
            eval_batch = {k: v.expand((fleet.replicates,) + v.shape)
                          for k, v in eval_batch.items()}
            evaluate = lambda params, batch: tuple(
                v.mean() for v in fleet_eval(one, params, batch))
    if args.no_scan:
        source = TJ.HostBatches(batcher, dev)
        chunk = 1
        print("[train] per-round loop: host batches")
    else:
        source = ClassificationStore.build(x, y, parts, args.batch_size, dev)
        coher = (sim.scenario.fading.coherence_rounds
                 if sim is not None else None)
        chunk = (args.chunk_rounds if args.chunk_rounds > 0
                 else TJ.auto_chunk(args.eval_every, coher))
        print(f"[train] chunked trajectory: chunk={chunk} rounds"
              + (f", telemetry: {','.join(tele.fields)}" if tele else ""))
    body = TJ.make_round_body(cfg, proto, source, spec, dev,
                              sim=None if fleet is not None else sim,
                              fleet=fleet, telemetry=tele)
    guard = lambda: obs.no_implicit_transfers(not args.no_transfer_guard,
                                              dev)
    if args.no_scan:
        # the guard holds each round; the per-round executor's copy of the
        # round's metrics to the host stays outside it
        def guarded(carry):
            with guard():
                return body(carry)

        run_rounds = lambda carry, n: TJ.run_per_round(guarded, carry, n)
    else:
        # the hot path, a whole chunk: it touches device tensors only
        def run_rounds(carry, n):
            with guard():
                return TJ.run_chunk(body, carry, n)

    eps0 = (obs.init_eps_moments(
                fleet.replicates if fleet is not None else None, device=dev)
            if tele is not None and tele.epsilon else None)
    carry = TJ.TrajCarry(gen, spec.flatten(wp) if spec is not None else wp,
                         net, eps0)
    del wp       # the flat path trains on its copy: one [N, d] less held
    eps_dog = (obs.EpsilonBudgetWatchdog(
                   args.eps_budget,
                   on_warn=runlog.warn if runlog is not None else
                   (lambda msg, **kw: print(f"[train] WARNING: {msg}")))
               if args.eps_budget > 0 else None)
    retrace_dog = obs.RetraceWatchdog(obs.guard.LibraryBuilds(),
                                      runlog=runlog, label="kernels")
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
            if carry.eps is not None and (do_eval or eps_dog is not None):
                _quote_eps(args, proto, carry, out, tele, t, do_eval,
                           eps_dog, runlog)
            if do_eval:
                params = (spec.unravel(carry.params) if spec is not None
                          else carry.params)
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
    except BaseException:
        if runlog is not None:
            runlog.close("error")
        raise
    finally:
        if logf:
            logf.close()
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


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
