"""Fleet quickstart on the PyTorch port: a whole fleet of wireless
networks in one round (the reference's ``examples/fleet_quickstart.py``).

    PYTHONPATH=src python examples/port_fleet_quickstart.py
    PYTHONPATH=src python examples/port_fleet_quickstart.py --device cpu

``port_dynamic_quickstart.py`` advances one time-varying network a round;
here R = 8 independent iot_dense networks of N = 8 workers advance
together (``repro_torch.fleet``): different fading, placement, churn,
data order and noise per replicate, one round for all of them
(``FleetEngine.make_fleet_round``: the simulator's round over the
stacked state, then the R-way worker-tree step). Each replicate takes its
own host batch stream; all share the dataset and partition. The rounds
run under the round guards of the dynamic quickstart (no host read, no
kernel build after round 0, the same operations every round). At the
end the eval as an across-replicate mean +- 95% CI, and the batched
privacy report: the R stacked channel trajectories as [R, T, N]
per-round budgets in one pass, the composed epsilon as a mean +- CI.
Runs on the card by default and raises without one. ``train`` is the
loop, a function of its operands.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.data import (FederatedBatcher, classification_dataset,
                              dirichlet_partition)
from repro_torch.fleet import (FleetEngine, fleet_epsilon_report, fleet_eval,
                               mean_ci, stack_rounds)
from repro_torch.models import mlp
from repro_torch.obs.guard import RoundGuards
from repro_torch.runtime import resolve_device

N, R, ROUNDS = 8, 8, 30
INPUT_DIM, HIDDEN, BATCH, EVAL_EVERY = 64, 32, 16, 10
PROTO = dict(scheme="dwfl", n_workers=N, gamma=0.02, eta=0.4, clip=1.0,
             p_dbm=75.0, target_epsilon=1.0, channel_model="dynamic",
             scenario="iot_dense", noise_policy="equal", replicates=R)


def setup(device="cuda"):
    """(proto, cfg, batchers, generator, worker_params [R, N, ...]): one
    batcher a replicate (shuffle seed r) over one dataset and partition;
    each replicate's workers start from its own init, drawn in replicate
    order from the generator (seed 0), which the run then goes on
    drawing from."""
    dev = resolve_device(device)
    x, y = classification_dataset(4000, input_dim=INPUT_DIM, seed=0)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=0)
    batchers = [FederatedBatcher(x, y, parts, batch_size=BATCH, seed=r)
                for r in range(R)]
    cfg = DWFL_PAPER.replace(d_model=HIDDEN)
    gen = torch.Generator(device=dev).manual_seed(0)
    inits = [mlp.init(gen, cfg, input_dim=INPUT_DIM, device=dev)
             for _ in range(R)]
    wp = X.tree_map(lambda *ls: torch.stack(ls)[:, None].expand(
        (R, N) + tuple(ls[0].shape)).contiguous(), *inits)
    return P.ProtocolConfig(**PROTO), cfg, batchers, gen, wp


def fleet_batches(batchers, device):
    """The fleet's [R, N, B, ...] batches, the R batchers' next stacked and
    uploaded, one a round."""
    while True:
        draws = [b.next() for b in batchers]
        yield {k: torch.as_tensor(np.stack([d[k] for d in draws]),
                                  device=device) for k in draws[0]}


def train(fleet_round, generator, states, wp, batches, rounds: int = ROUNDS,
          eval_every: int = EVAL_EVERY, guards=None, on_round=None):
    """``rounds`` calls of ``fleet_round`` (``make_fleet_round``'s
    signature: (generator, states, wp, batch) -> (states', wp', metrics,
    chans, Ws)), round t on ``next(batches)`` (drawn before its guards),
    each under ``guards.round(t)`` (None: unguarded); after every
    ``eval_every``-th round ``on_round(t, metrics)``, outside the guards.
    Returns (states, wp, chans, Ws): the per-round [R, ...] channels and
    Ws, stacked by the caller (``stack_rounds``)."""
    chans, Ws = [], []
    for t in range(rounds):
        batch = next(batches)
        if guards is None:
            states, wp, metrics, chan, W = fleet_round(generator, states, wp,
                                                       batch)
        else:
            with guards.round(t):
                states, wp, metrics, chan, W = fleet_round(generator, states,
                                                           wp, batch)
        chans.append(chan)
        Ws.append(W)
        if t % eval_every == 0 and on_round is not None:
            on_round(t, metrics)
    return states, wp, chans, Ws


def read_out(proto, evaluate, wp, full, chans, Ws) -> dict:
    """The across-replicate read-out: eval loss and accuracy as mean +-
    CI, and the batched epsilon report of the stacked rounds."""
    losses, accs = fleet_eval(evaluate, wp, full)
    lm, lc = mean_ci(losses.cpu().numpy())
    am, ac = mean_ci(accs.cpu().numpy())
    rep = fleet_epsilon_report(proto, stack_rounds(chans), stack_rounds(Ws))
    return {"loss_mean": lm, "loss_ci95": lc, "acc_mean": am, "acc_ci95": ac,
            "epsilon_composed_mean": rep["epsilon_composed_mean"],
            "epsilon_composed_ci95": rep["epsilon_composed_ci95"],
            "epsilon_worst": rep["epsilon_worst"],
            "delta_composed": rep["delta_composed"], "report": rep}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1-2. a replicated federation: R independent iot_dense networks
    proto, cfg, batchers, gen, wp = setup(dev)
    fleet = FleetEngine(proto, device=dev)

    # 3. one call a round for the whole fleet: the networks' round and
    # the R-way DWFL step
    fleet_round = fleet.make_fleet_round(cfg)
    states = fleet.init(gen)
    guards = RoundGuards(dev, label="fleet")
    printed = []

    def on_round(t, metrics):
        losses = [round(v, 3) for v in metrics["loss"].tolist()]
        printed.append({"round": t, "loss": losses})
        print(f"round {t:3d}  loss/replicate={losses}  "
              f"guarded rounds={guards.rounds}", flush=True)

    states, wp, chans, Ws = train(fleet_round, gen, states, wp,
                                  fleet_batches(batchers, dev), args.rounds,
                                  guards=guards, on_round=on_round)

    # 4. the across-replicate read-out
    one = batchers[0].full(256)
    full = {k: torch.as_tensor(v, device=dev).expand((R,) + v.shape)
            for k, v in one.items()}
    out = read_out(proto, P.make_eval_fn(cfg), wp, full, chans, Ws)
    print(f"\nafter {args.rounds} rounds x {R} replicates "
          f"(guarded rounds={guards.rounds}, {guards.ops} device operations "
          f"each):")
    print(f"  eval loss {out['loss_mean']:.4f} ± {out['loss_ci95']:.4f}   "
          f"acc {out['acc_mean']:.3f} ± {out['acc_ci95']:.3f}")
    print(f"  composed eps {out['epsilon_composed_mean']:.3g} "
          f"± {out['epsilon_composed_ci95']:.2g} "
          f"(worst single round {out['epsilon_worst']:.3g}, "
          f"delta {out['delta_composed']:.2g})")
    out.update(rounds=args.rounds, evals=printed, ops_per_round=guards.ops,
               guarded_rounds=guards.rounds)
    out["state"] = {"wp": wp, "report": out.pop("report")}
    return out


if __name__ == "__main__":
    main()
