"""End-to-end driver on the PyTorch port: DWFL-train a transformer LM
(the reference's ``examples/train_dwfl_e2e.py``, the paper's required
training example).

    PYTHONPATH=src python examples/port_train_dwfl_e2e.py --steps 200
    PYTHONPATH=src python examples/port_train_dwfl_e2e.py --size 100m --steps 300
    PYTHONPATH=src python examples/port_train_dwfl_e2e.py --device cpu --steps 20

``--size 100m`` is the production configuration (a ~100M-parameter
dense LM, for the card); ``--size 2m`` (the default) the same code path
at a size the CPU finishes in minutes. W workers (default 4) each train
on their own slice of the synthetic token stream (8 windows of 128 a
round), the worker-tree round of ``--scheme`` (``make_train_step``: the
reference passes no ``use_pallas`` to the LM's loss, so no hand kernel
runs), sigma calibrated to ``--epsilon`` a round. It prints the loss
every tenth of the run with tokens/s (the host's clock since the first
round, which it includes), the loss trend over the first and last ten
rounds, and with ``--checkpoint PATH`` writes PATH.npz and PATH.json
(``repro_torch.checkpoint``, the reference's format). Runs on the card by
default and raises without one. ``train`` is the loop, a function of its
operands.
"""
import argparse
import itertools
import time

import torch

from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs.base import ModelConfig
from repro_torch.core import protocol as P
from repro_torch.core.trajectory import HostBatches
from repro_torch.data import LMBatcher, lm_dataset
from repro_torch.models import model as M
from repro_torch.runtime import resolve_device

SIZES = {
    # ~2M params: the production code path at a size the CPU runs
    "2m": ModelConfig(name="dwfl-lm-2m", family="dense", num_layers=4,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=2048, tie_embeddings=True),
    # ~10M params
    "10m": ModelConfig(name="dwfl-lm-10m", family="dense", num_layers=6,
                       d_model=320, num_heads=8, num_kv_heads=4, d_ff=1280,
                       vocab_size=8192, tie_embeddings=True),
    # ~100M params: the production configuration
    "100m": ModelConfig(name="dwfl-lm-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=4, d_ff=3072,
                        vocab_size=32768, tie_embeddings=True),
}


def train(step, wp, batches, generator, rounds: int, noise=None,
          on_round=None):
    """``rounds`` rounds of ``step`` (``make_train_step``'s), round t on
    ``next(batches)``, its noise drawn from ``generator`` or, with
    ``noise``, ``next(noise)`` (the round's normals). ``on_round(t,
    metrics)`` after each round. Returns (wp, losses [rounds] as device
    scalars)."""
    losses = []
    for t in range(rounds):
        normals = None if noise is None else next(noise)
        wp, metrics = step(wp, next(batches), generator, normals=normals)
        losses.append(metrics["loss"])
        if on_round is not None:
            on_round(t, metrics)
    return wp, losses


def verdict(first: float, last: float) -> str:
    """The reference's three readings of the loss trend."""
    if last < first - 0.02:
        return "[e2e] loss IMPROVED under the protocol."
    if last < first * 1.15:
        return ("[e2e] loss at the DP/channel noise floor (stable, not "
                "diverging): per-round DP training at this ε needs thousands "
                "of rounds to show net progress — the DP-SGD reality. Run "
                "--scheme gossip or --epsilon 0... for the noiseless "
                "dynamics, or examples/port_compare_schemes.py (classifier "
                "task) for visible-in-minutes convergence under DP.")
    return ("[e2e] WARNING: loss diverged — check channel power (--p-dbm) "
            "vs the worst-channel alignment (DESIGN.md §6b).")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="2m", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8, help="per-worker")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--epsilon", type=float, default=2.0,
                    help="per-round DP target; 0 disables (gossip-like noise)")
    ap.add_argument("--gamma", type=float, default=0.02)
    ap.add_argument("--p-dbm", type=float, default=80.0)
    ap.add_argument("--scheme", default="dwfl",
                    choices=["dwfl", "gossip", "orthogonal", "centralized"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = SIZES[args.size]
    W = args.workers
    proto = P.ProtocolConfig(scheme=args.scheme, n_workers=W, gamma=args.gamma,
                             eta=0.3, clip=1.0, target_epsilon=args.epsilon,
                             p_dbm=args.p_dbm)
    rep = P.epsilon_report(proto, proto.channel())

    gen = torch.Generator(device=dev).manual_seed(0)
    wp = P.init_worker_params(gen, cfg, W, dev)
    n = M.count_params(wp) // W
    print(f"[e2e] {cfg.name}: {n/1e6:.1f}M params x {W} workers, "
          f"eps/round={rep['epsilon_worst']:.3g} sigma={rep['sigma']:.3g}",
          flush=True)

    toks = lm_dataset(W * 120_000, cfg.vocab_size, seed=0)
    source = HostBatches(LMBatcher(toks, W, args.batch, args.seq_len, seed=0),
                         dev)
    batches = (source.draw(gen) for _ in itertools.count())
    step = P.make_train_step(cfg, proto, dev)
    tokens_a_round = W * args.batch * args.seq_len
    every = max(1, args.steps // 10)
    printed = []
    t0 = time.time()

    def on_round(t, metrics):
        if t % every == 0:
            loss = float(metrics["loss"])
            tok_s = (t + 1) * tokens_a_round / (time.time() - t0)
            printed.append({"round": t, "loss": loss, "tok_s": tok_s})
            print(f"[e2e] round {t:4d}  loss={loss:.4f}  ({tok_s:,.0f} tok/s)",
                  flush=True)

    wp, losses = train(step, wp, batches, gen, args.steps + 1,
                       on_round=on_round)
    losses = torch.stack(losses).tolist()
    seconds = time.time() - t0
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    print(f"[e2e] loss {first:.3f} -> {last:.3f} in {seconds:.0f}s")
    trend = verdict(first, last)
    print(trend)
    if args.checkpoint:
        ckpt_save(args.checkpoint, wp, step=args.steps,
                  metadata={"size": args.size})
        print(f"[e2e] checkpoint -> {args.checkpoint}")
    return {"params": n, "workers": W, "epsilon": rep["epsilon_worst"],
            "sigma": rep["sigma"], "evals": printed, "losses": losses,
            "first": first, "last": last, "seconds": seconds,
            "rounds": args.steps + 1, "tokens_per_round": tokens_a_round,
            "verdict": trend, "checkpoint": args.checkpoint,
            "state": {"wp": wp, "cfg": cfg, "proto": proto}}


if __name__ == "__main__":
    main()
