"""Quickstart on the PyTorch port: DWFL (the paper's Algorithm 1) end to
end on the flat buffer, one fused dp_mix round a step (the reference's
``examples/quickstart.py``).

    PYTHONPATH=src python examples/port_quickstart.py
    PYTHONPATH=src python examples/port_quickstart.py --device cpu

The reference's settings: N = 10 workers on non-IID data (input 256,
Dirichlet 0.5), the paper's MLP at hidden 64, gamma 0.02, eta 0.4, clip
1, p 75 dBm, sigma calibrated to eps = 1 a round; 301 rounds, evaluated
every 100 through ``spec.unravel``. On the card every round is one
launch of the hand-written dp_mix kernel (local SGD, the counter-hash DP
noise, the mixing GEMM, self-correction and AWGN in one pass over the
[N, d] buffer), counted and printed; on the CPU it is its plain version.
Runs on the card by default and raises without one. ``train`` is the
loop, a function of its operands (buffer, batches, noise seeds), so a
caller can replay another run's draws into it.
"""
import argparse
import itertools

import torch

from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core.trajectory import HostBatches, round_seed
from repro_torch.data import (FederatedBatcher, classification_dataset,
                              dirichlet_partition)
from repro_torch.kernels.dp_mix import ops as mix_ops
from repro_torch.models import mlp
from repro_torch.runtime import resolve_device

N, INPUT_DIM, HIDDEN, BATCH = 10, 256, 64, 32
ROUNDS, EVAL_EVERY = 301, 100
PROTO = dict(scheme="dwfl", n_workers=N, gamma=0.02, eta=0.4, clip=1.0,
             p_dbm=75.0, target_epsilon=1.0)


def setup(device="cuda"):
    """The federation, protocol and model: (proto, cfg, batcher, spec,
    flat [N, d]); every worker starts from one init (generator seed 0)."""
    dev = resolve_device(device)
    x, y = classification_dataset(6000, input_dim=INPUT_DIM, seed=0)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=0)
    batcher = FederatedBatcher(x, y, parts, batch_size=BATCH)
    proto = P.ProtocolConfig(**PROTO)
    cfg = DWFL_PAPER.replace(d_model=HIDDEN)
    params = mlp.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      input_dim=INPUT_DIM, device=dev)
    wp = X.tree_map(lambda a: a.expand((N,) + tuple(a.shape)).contiguous(),
                    params)
    spec = X.make_flat_spec(wp)
    return proto, cfg, batcher, spec, spec.flatten(wp)


def train(step, evaluate, spec, flat, batches, seeds, eval_batch,
          rounds: int = ROUNDS, eval_every: int = EVAL_EVERY, on_eval=None):
    """``rounds`` rounds of ``step`` (``make_flat_train_step``'s) over the
    flat buffer, round t taking ``next(batches)`` and ``next(seeds)``;
    after every ``eval_every``-th round the eval of the unraveled buffer on
    ``eval_batch``, handed to ``on_eval(t, train_loss, eval_acc)`` as
    device scalars. Returns (flat, evals [(t, train_loss, eval_acc)],
    last): ``last`` is the final round's operands, {"flat": the buffer
    before it, "batch", "seed"}."""
    evals, last = [], None
    for t in range(rounds):
        batch, seed = next(batches), next(seeds)
        last = {"flat": flat, "batch": batch, "seed": seed}
        flat, metrics = step(flat, batch, seed)
        if t % eval_every == 0:
            _, acc = evaluate(spec.unravel(flat), eval_batch)
            evals.append((t, metrics["loss"], acc))
            if on_eval is not None:
                on_eval(t, metrics["loss"], acc)
    return flat, evals, last


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1-2. the federation and the protocol: analog over-the-air exchange,
    # per-round (eps, delta)-DP
    proto, cfg, batcher, spec, flat = setup(dev)
    chan = proto.channel()
    privacy = {k: round(v, 4) for k, v in P.epsilon_report(proto, chan).items()
               if isinstance(v, float)}
    print("privacy:", privacy)

    # 3-4. the flat buffer: raveled once, one fused dp_mix round a step,
    # the tree recovered only at eval time
    step = P.make_flat_train_step(cfg, proto, spec, dev)
    evaluate = P.make_eval_fn(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    source = HostBatches(batcher, dev)
    batches = (source.draw(gen) for _ in itertools.count())
    seeds = (round_seed(gen) for _ in itertools.count())
    eval_batch = {k: torch.as_tensor(v, device=dev)
                  for k, v in batcher.full(128).items()}
    printed = []

    def on_eval(t, loss, acc):
        printed.append({"round": t, "train_loss": float(loss),
                        "eval_acc": float(acc)})
        print(f"round {t:4d}  train_loss={printed[-1]['train_loss']:.3f}  "
              f"eval_acc={printed[-1]['eval_acc']:.3f}", flush=True)

    before = mix_ops.dp_mix_round.launches
    flat, _, last = train(step, evaluate, spec, flat, batches, seeds,
                          eval_batch, args.rounds, on_eval=on_eval)
    launches = mix_ops.dp_mix_round.launches - before
    eps = round(P.epsilon_report(proto, chan)["epsilon_worst"], 3)
    print("done — per-round epsilon:", eps)
    where = ("" if dev.type == "cuda"
             else " (the CPU runs dp_mix's plain version)")
    print(f"dp_mix launches: {launches} in {args.rounds} rounds{where}")
    return {"privacy": privacy, "evals": printed, "epsilon": eps,
            "rounds": args.rounds, "launches": launches,
            "state": {"proto": proto, "cfg": cfg, "spec": spec,
                      "flat": flat, "last": last}}


if __name__ == "__main__":
    main()
