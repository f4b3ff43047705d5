"""Dev check on the PyTorch port: DWFL on the paper-scale MLP converges on
synthetic data (the reference's ``scripts/dev_dwfl.py``).

    PYTHONPATH=src python scripts/port_dev_dwfl.py
    PYTHONPATH=src python scripts/port_dev_dwfl.py --device cpu --rounds 51

dwfl-paper at full width (3072 -> 256 -> 256 -> 10), N = 10 workers on
20,000 samples (Dirichlet 0.5), batch 64, the worker-tree round
(``make_train_step``) at gamma 0.05, eta 0.5, clip 5, sigma = sigma_m =
1, p 60 dBm, channel seed 1; 201 rounds, the eval on 256 samples a worker
every 50, then the workers' variance (consensus). Runs on the card by
default and raises without one.
"""
import argparse
import itertools
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core.trajectory import HostBatches
from repro_torch.data import (FederatedBatcher, classification_dataset,
                              dirichlet_partition)
from repro_torch.runtime import resolve_device

N, ROUNDS, EVAL_EVERY = 10, 201, 50


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("dwfl-paper")
    proto = P.ProtocolConfig(scheme="dwfl", n_workers=N, gamma=0.05, eta=0.5,
                             clip=5.0, sigma=1.0, sigma_m=1.0, p_dbm=60.0,
                             seed=1)
    chan = proto.channel()
    print("channel: c=%.4g alpha=%s" % (chan.c, np.round(chan.alpha, 3)))
    rep = P.epsilon_report(proto, chan)
    print("eps report:", {k: v for k, v in rep.items()
                          if k != "epsilon_per_worker"})

    x, y = classification_dataset(20000, seed=0)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=0)
    bat = FederatedBatcher(x, y, parts, batch_size=64)
    gen = torch.Generator(device=dev).manual_seed(0)
    wp = P.init_worker_params(gen, cfg, N, dev)
    step = P.make_train_step(cfg, proto, dev)
    evaluate = P.make_eval_fn(cfg)
    source = HostBatches(bat, dev)
    batches = (source.draw(gen) for _ in itertools.count())
    full = {k: torch.as_tensor(v, device=dev)
            for k, v in bat.full(256).items()}

    evals = []
    t0 = time.time()
    for t in range(args.rounds):
        wp, metrics = step(wp, next(batches), gen)
        if t % EVAL_EVERY == 0:
            ev_loss, ev_acc = evaluate(wp, full)
            row = {"round": t, "loss": float(metrics["loss"]),
                   "eval": float(ev_loss), "acc": float(ev_acc),
                   "gnorm": float(metrics["grad_norm"]),
                   "pnorm": float(metrics["param_norm"])}
            evals.append(row)
            print(f"t={t:4d} loss={row['loss']:.4f} eval={row['eval']:.4f} "
                  f"acc={row['acc']:.3f} gnorm={row['gnorm']:.3f} "
                  f"pnorm={row['pnorm']:.2f}", flush=True)
    seconds = time.time() - t0
    print(f"{seconds:.1f}s")

    # consensus: the workers should agree increasingly
    leaves, _ = X.tree_flatten(wp)
    dev_var = float(sum(torch.sum(torch.var(l.float(), dim=0,
                                            unbiased=False))
                        for l in leaves))
    print("worker variance (consensus):", dev_var)
    return {"evals": evals, "seconds": seconds, "consensus": dev_var,
            "epsilon": rep["epsilon_worst"]}


if __name__ == "__main__":
    main()
