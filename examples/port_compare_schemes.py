"""The paper's scheme comparisons in one run on the PyTorch port (Figs. 5
and 6): DWFL against orthogonal transmission, a centralized parameter
server and noiseless gossip, all at the same per-round privacy target
(the reference's ``examples/compare_schemes.py``).

    PYTHONPATH=src python examples/port_compare_schemes.py --steps 250
    PYTHONPATH=src python examples/port_compare_schemes.py --device cpu

The harness is the reference's shared benchmark task
(``benchmarks/common.py``: ``_setup_task``, ``_finish``,
``run_protocol``), kept here: the paper's MLP at input 256 and hidden 64
on the synthetic CIFAR-shaped task, Dirichlet 0.5 across the workers,
batch 32, p 60 dBm, the worker-tree round of each scheme
(``make_train_step``), one warm-up step, then ``--steps`` timed steps and
the eval on 128 samples a worker. The comparisons, not the absolute
accuracies, are what reproduce the paper's claims. ``us/step`` is the
host's clock around the timed steps, ending in a device synchronize: on
the card it is the card's time a step (the rounds are host-bound at this
size), on the CPU the CPU's. Runs on the card by default and raises
without one. ``run_steps`` is the loop, a function of its operands.
"""
import argparse
import itertools
import time
from typing import Dict, List

import torch

from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core.trajectory import HostBatches
from repro_torch.data import (FederatedBatcher, classification_dataset,
                              dirichlet_partition)
from repro_torch.models import mlp
from repro_torch.runtime import resolve_device

INPUT_DIM = 256
HIDDEN = 64
BATCH = 32
DATA_N = 6000
SCHEMES = ("gossip", "dwfl", "orthogonal", "centralized")


def _setup_task(proto: P.ProtocolConfig, seed: int, device="cuda"):
    """The reduced benchmark task: (config, batcher, replicated init
    parameters, eval fn, generator seeded ``seed``)."""
    dev = resolve_device(device)
    cfg = DWFL_PAPER.replace(d_model=HIDDEN)
    x, y = classification_dataset(DATA_N, input_dim=INPUT_DIM, seed=seed)
    parts = dirichlet_partition(y, proto.n_workers, alpha=0.5, seed=seed)
    bat = FederatedBatcher(x, y, parts, batch_size=BATCH, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = mlp.init(gen, cfg, input_dim=INPUT_DIM, device=dev)
    wp = X.tree_map(lambda a: a.expand((proto.n_workers,) + tuple(a.shape))
                    .contiguous(), params)
    return cfg, bat, wp, P.make_eval_fn(cfg), gen


def _finish(wp, bat, evaluate, us_per_step: float, eps_fields: Dict,
            curve: List, device) -> Dict:
    ev_loss, ev_acc = evaluate(wp, {k: torch.as_tensor(v, device=device)
                                    for k, v in bat.full(128).items()})
    return {"us_per_call": us_per_step, "final_loss": float(ev_loss),
            "final_acc": float(ev_acc), "curve": curve, **eps_fields}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(step, wp, batches, generator, steps: int, noise=None,
              evaluate=None, eval_batch=None, eval_every: int = 0):
    """``steps`` rounds of ``step`` (``make_train_step``'s), round t on
    ``next(batches)``, its noise drawn from ``generator`` or, with
    ``noise``, ``next(noise)`` (the round's normals). Returns (wp, curve):
    with ``eval_every``, (t, eval loss, eval acc) every such round."""
    curve = []
    for t in range(steps):
        normals = None if noise is None else next(noise)
        wp, _ = step(wp, next(batches), generator, normals=normals)
        if eval_every and t % eval_every == 0:
            el, ea = evaluate(wp, eval_batch)
            curve.append((t, float(el), float(ea)))
    return wp, curve


def run_protocol(scheme: str, *, n_workers: int, epsilon: float,
                 p_dbm: float = 60.0, steps: int = 250, gamma: float = 0.02,
                 eta: float = 0.4, clip: float = 1.0, seed: int = 0,
                 eval_every: int = 0, participation: float = 1.0,
                 device="cuda") -> Dict:
    dev = resolve_device(device)
    proto = P.ProtocolConfig(scheme=scheme, n_workers=n_workers, gamma=gamma,
                             eta=eta, clip=clip, p_dbm=p_dbm, seed=seed,
                             target_epsilon=epsilon,
                             participation=participation)
    rep = P.epsilon_report(proto, proto.channel())
    cfg, bat, wp, evaluate, gen = _setup_task(proto, seed, dev)
    step = P.make_train_step(cfg, proto, dev)
    source = HostBatches(bat, dev)
    batches = (source.draw(gen) for _ in itertools.count())
    eval_batch = ({k: torch.as_tensor(v, device=dev)
                   for k, v in bat.full(128).items()} if eval_every else None)

    wp, _ = run_steps(step, wp, batches, gen, 1)          # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    wp, curve = run_steps(step, wp, batches, gen, steps, evaluate=evaluate,
                          eval_batch=eval_batch, eval_every=eval_every)
    _sync(dev)
    us_per_step = (time.perf_counter() - t0) / steps * 1e6
    return _finish(wp, bat, evaluate, us_per_step, {
        "epsilon": rep["epsilon_worst"],
        "epsilon_sampled": rep.get("epsilon_sampled"),
        "sigma": rep["sigma"],
    }, curve, dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--epsilon", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    print(f"{'scheme':>14s} {'final_acc':>10s} {'final_loss':>11s} "
          f"{'eps/round':>10s} {'us/step':>9s}")
    results = {}
    for scheme in SCHEMES:
        res = run_protocol(scheme, n_workers=args.workers,
                           epsilon=args.epsilon, steps=args.steps, seed=1,
                           device=args.device)
        results[scheme] = res
        print(f"{scheme:>14s} {res['final_acc']:>10.3f} "
              f"{res['final_loss']:>11.3f} {res['epsilon']:>10.3g} "
              f"{res['us_per_call']:>9.0f}", flush=True)

    print()
    d, o, c = (results[s]["final_acc"]
               for s in ("dwfl", "orthogonal", "centralized"))
    fig5, fig6 = d > o, d > c
    print(f"Fig.5 claim (analog beats orthogonal at same eps): "
          f"{'REPRODUCED' if fig5 else 'NOT reproduced'} ({d:.3f} vs {o:.3f})")
    print(f"Fig.6 claim (decentralized beats centralized):      "
          f"{'REPRODUCED' if fig6 else 'NOT reproduced'} ({d:.3f} vs {c:.3f})")
    return {"schemes": results, "fig5_reproduced": fig5,
            "fig6_reproduced": fig6}


if __name__ == "__main__":
    main()
