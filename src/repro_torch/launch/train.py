"""End-to-end DWFL training CLI of the port — the static paths of the
reference's ``repro.launch.train``: the paper's MLP, the static Rayleigh
channel, one of the four schemes of the paper's comparison (dwfl,
orthogonal, centralized, gossip), K-round chunks with on-device batch
sampling. Without ``--flat-buffer`` it runs the worker-tree round
(protocol.make_train_step: per-leaf noise, the mixing engine); with it the
fused dp_mix round on the flat [N, d] buffer (dwfl and gossip only), as
the reference does. ``--no-scan`` takes each round's batch from the host
batcher instead, one round at a time.

    python -m repro_torch.launch.train --arch dwfl-paper --flat-buffer
    python -m repro_torch.launch.train --scheme orthogonal --steps 300
    python -m repro_torch.launch.train --device cpu --hidden 16 --workers 4 --steps 3

Runs on the card by default and raises without one; ``--device cpu``
runs the plain PyTorch versions of the kernels. Flags of the reference
that this port does not carry yet exit with the ROADMAP item that will
port them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core import trajectory as TJ
from repro_torch.data import (ClassificationStore, FederatedBatcher,
                              classification_dataset, dirichlet_partition)
from repro_torch.runtime import resolve_device

# reference flags not ported yet -> the ROADMAP item that ports them
NOT_PORTED = {
    "--reduced": "A15",
    "--seq-len": "A15", "--total-epsilon": "A6", "--accountant": "A6",
    "--channel-model": "A9", "--scenario": "A9", "--coherence-rounds": "A9",
    "--graph-fallback": "A9", "--sparse-neighbors": "A10",
    "--worker-shards": "A14", "--model-shards": "A14",
    "--max-chunk-cols": "A14", "--remat": "A14", "--replicates": "A12",
    "--checkpoint": "A13", "--log": "A11", "--runlog-dir": "A11",
    "--telemetry": "A11", "--eps-budget": "A11",
    "--no-transfer-guard": "A11",
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
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--sigma-m", type=float, default=1.0)
    ap.add_argument("--p-dbm", type=float, default=60.0)
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5)
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
    return args


def run(argv=None) -> dict:
    """Train as ``main`` does and return what the run measured: per-round
    losses [T] (CPU tensor), the eval records, the loop's wall seconds
    and the final parameters (the flat buffer with ``--flat-buffer``,
    else the worker tree)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = DWFL_PAPER
    if args.hidden > 0:
        cfg = dataclasses.replace(cfg, d_model=args.hidden)
    W = args.workers
    proto = P.ProtocolConfig(
        scheme=args.scheme, n_workers=W, gamma=args.gamma, eta=args.eta,
        clip=args.clip, sigma=args.sigma, sigma_m=args.sigma_m,
        p_dbm=args.p_dbm, seed=args.seed, target_epsilon=args.epsilon,
        flat_buffer=args.flat_buffer)
    if proto.flat_buffer and args.scheme not in ("dwfl", "gossip"):
        raise SystemExit("--flat-buffer supports the mixing-family schemes "
                         "only (dwfl/gossip)")
    chan = proto.channel()
    rep = P.epsilon_report(proto, chan)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[train] device: {dev} ({name})")
    print(f"[train] {args.arch} scheme={args.scheme} N={W} "
          f"eps={rep['epsilon_worst']:.3g}/round sigma={rep['sigma']:.3g} "
          f"(orthogonal would be eps={rep['epsilon_orthogonal_worst']:.3g})")

    x, y = classification_dataset(args.dataset_size, seed=args.seed)
    parts = dirichlet_partition(y, W, alpha=args.dirichlet_alpha,
                                seed=args.seed)
    batcher = FederatedBatcher(x, y, parts, args.batch_size, seed=args.seed)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    wp = P.init_worker_params(gen, cfg, W, dev)
    layout = X.FlatSpec(wp)
    spec = layout if proto.flat_buffer else None
    print(f"[train] params/worker: {layout.d / 1e6:.2f}M"
          + (" (flat dp_mix buffer)" if proto.flat_buffer else ""))

    evaluate = P.make_eval_fn(cfg)
    eval_batch = None
    if args.eval_every > 0:
        eval_batch = {k: torch.as_tensor(v, device=dev)
                      for k, v in batcher.full(256).items()}
    if args.no_scan:
        source = TJ.HostBatches(batcher, dev)
        run_rounds, chunk = TJ.run_per_round, 1
        print("[train] per-round loop: host batches")
    else:
        source = ClassificationStore.build(x, y, parts, args.batch_size, dev)
        run_rounds = TJ.run_chunk
        chunk = (args.chunk_rounds if args.chunk_rounds > 0
                 else TJ.auto_chunk(args.eval_every))
        print(f"[train] chunked trajectory: chunk={chunk} rounds")
    body = TJ.make_round_body(cfg, proto, source, spec, dev)

    carry = TJ.TrajCarry(gen, spec.flatten(wp) if spec is not None else wp)
    losses, evals = [], []
    t0 = time.time()
    t = 0
    for n, do_eval in TJ.plan_chunks(args.steps + 1, chunk, args.eval_every):
        carry, out = run_rounds(body, carry, n)
        t += n
        losses.append(out["metrics"]["loss"])
        if do_eval:
            params = (spec.unravel(carry.params) if spec is not None
                      else carry.params)
            ev_loss, ev_acc = evaluate(params, eval_batch)
            rec = {"step": t - 1,
                   "loss": float(out["metrics"]["loss"][-1]),
                   "eval_loss": float(ev_loss), "eval_acc": float(ev_acc),
                   "grad_norm": float(out["metrics"]["grad_norm"][-1]),
                   "wall_s": round(time.time() - t0, 1)}
            evals.append(rec)
            print(f"[train] step={rec['step']:5d} loss={rec['loss']:.4f} "
                  f"eval={rec['eval_loss']:.4f} acc={rec['eval_acc']:.3f} "
                  f"({rec['wall_s']}s)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    return {"losses": torch.cat([l.cpu() for l in losses]), "evals": evals,
            "rounds": t, "seconds": seconds, "params": carry.params,
            "epsilon_worst": rep["epsilon_worst"]}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
