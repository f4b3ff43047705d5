"""End-to-end DWFL training driver of the port — the main path of the
reference's ``repro.launch.train``: the paper's MLP on the flat [N, d]
buffer, the static Rayleigh channel, the complete graph, one fused
dp_mix round per step, K-round chunks with on-device batch sampling.

    python -m repro_torch.launch.train --arch dwfl-paper --flat-buffer
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
    "--scheme": "A8", "--no-scan": "A8", "--reduced": "A15",
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
                    help="accepted for parity: the port always trains on "
                         "the flat dp_mix buffer")
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
    and the final flat buffer."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = DWFL_PAPER
    if args.hidden > 0:
        cfg = dataclasses.replace(cfg, d_model=args.hidden)
    W = args.workers
    proto = P.ProtocolConfig(
        n_workers=W, gamma=args.gamma, eta=args.eta, clip=args.clip,
        sigma=args.sigma, sigma_m=args.sigma_m, p_dbm=args.p_dbm,
        seed=args.seed, target_epsilon=args.epsilon)
    chan = proto.channel()
    rep = P.epsilon_report(proto, chan)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[train] device: {dev} ({name})")
    print(f"[train] {args.arch} scheme={proto.scheme} N={W} "
          f"eps={rep['epsilon_worst']:.3g}/round sigma={rep['sigma']:.3g} "
          f"(orthogonal would be eps={rep['epsilon_orthogonal_worst']:.3g})")

    x, y = classification_dataset(args.dataset_size, seed=args.seed)
    parts = dirichlet_partition(y, W, alpha=args.dirichlet_alpha,
                                seed=args.seed)
    batcher = FederatedBatcher(x, y, parts, args.batch_size)
    store = ClassificationStore.build(x, y, parts, args.batch_size, dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    wp = P.init_worker_params(gen, cfg, W, dev)
    spec = X.FlatSpec(wp)
    flat = spec.flatten(wp)
    print(f"[train] params/worker: {spec.d / 1e6:.2f}M (flat dp_mix buffer)")

    evaluate = P.make_eval_fn(cfg)
    eval_batch = None
    if args.eval_every > 0:
        eval_batch = {k: torch.as_tensor(v, device=dev)
                      for k, v in batcher.full(256).items()}
    body = TJ.make_round_body(cfg, proto, store, spec, dev)
    chunk = (args.chunk_rounds if args.chunk_rounds > 0
             else TJ.auto_chunk(args.eval_every))
    print(f"[train] chunked trajectory: chunk={chunk} rounds")

    carry = TJ.TrajCarry(gen, flat)
    losses, evals = [], []
    t0 = time.time()
    t = 0
    for n, do_eval in TJ.plan_chunks(args.steps + 1, chunk, args.eval_every):
        carry, out = TJ.run_chunk(body, carry, n)
        t += n
        losses.append(out["metrics"]["loss"])
        if do_eval:
            ev_loss, ev_acc = evaluate(spec.unravel(carry.params), eval_batch)
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
    return {"losses": torch.cat(losses).cpu(), "evals": evals,
            "rounds": t, "seconds": seconds, "params": carry.params,
            "epsilon_worst": rep["epsilon_worst"]}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
