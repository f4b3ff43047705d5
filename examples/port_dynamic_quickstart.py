"""Dynamic-scenario quickstart on the PyTorch port: DWFL over a
time-varying wireless network (the reference's
``examples/dynamic_quickstart.py``).

    PYTHONPATH=src python examples/port_dynamic_quickstart.py
    PYTHONPATH=src python examples/port_dynamic_quickstart.py --device cpu

The static quickstart realizes ONE channel; here every round draws its
own from ``repro_torch.net`` — block fading re-aligned on the device every
coherence block (10 rounds), geometry-derived path gains, worker churn —
and hands the channel and mixing matrix to one train step as arguments
(the worker-tree round, ``make_dynamic_train_step``). The reference
asserts that its jitted step traced exactly once; an eager round cannot
retrace, so the port guards what could change instead
(``obs.guard.RoundGuards``): each round runs under the sync guard, reads
nothing on the host (a host read raises), builds no kernel library after
round 0, and dispatches as many operations as round 0, printed at the
end. The host reads the reference prints (c, active workers) happen at
the print points, outside the guarded round. At the end the per-round
epsilon trajectory (Theorem 4.1 on each realized round) and its
composition. Runs on the card by default and raises without one.
``train`` is the loop, a function of its operands.
"""
import argparse
import itertools

import torch

from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.core.trajectory import HostBatches
from repro_torch.data import (FederatedBatcher, classification_dataset,
                              dirichlet_partition)
from repro_torch.models import mlp
from repro_torch.net.state import stack_states
from repro_torch.obs.guard import RoundGuards
from repro_torch.runtime import resolve_device

N, INPUT_DIM, HIDDEN, BATCH = 10, 256, 64, 32
ROUNDS, EVAL_EVERY = 151, 50
PROTO = dict(scheme="dwfl", n_workers=N, gamma=0.02, eta=0.4, clip=1.0,
             p_dbm=75.0, target_epsilon=1.0, channel_model="dynamic",
             scenario="iot_dense", coherence_rounds=10)


def setup(device="cuda"):
    """(proto, cfg, batcher, worker_params [N, ...]): the static
    quickstart's data and model on a dynamic network."""
    dev = resolve_device(device)
    x, y = classification_dataset(6000, input_dim=INPUT_DIM, seed=0)
    batcher = FederatedBatcher(x, y, dirichlet_partition(y, N, alpha=0.5,
                                                         seed=0),
                               batch_size=BATCH)
    cfg = DWFL_PAPER.replace(d_model=HIDDEN)
    params = mlp.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      input_dim=INPUT_DIM, device=dev)
    wp = X.tree_map(lambda a: a.expand((N,) + tuple(a.shape)).contiguous(),
                    params)
    return P.ProtocolConfig(**PROTO), cfg, batcher, wp


def network_round(step, sim, state, generator):
    """The example's round: ``round_fn(wp, batch) -> (wp', metrics, chan,
    mask, W)``, the simulator's round drawn from ``generator`` (its state
    carried between calls), then the step, whose noise ``generator``
    draws."""
    box = [state]

    def round_fn(wp, batch):
        box[0], chan, mask, W = sim.round(generator, box[0])
        wp, metrics = step(wp, batch, generator, chan, W)
        return wp, metrics, chan, mask, W

    return round_fn


def train(round_fn, evaluate, wp, batches, eval_batch, rounds: int = ROUNDS,
          eval_every: int = EVAL_EVERY, guards=None, on_eval=None):
    """``rounds`` rounds of ``round_fn`` (``network_round``'s, or one that
    replays another run's channels, Ws and noise), round t on
    ``next(batches)`` (drawn before the round's guards), each under
    ``guards.round(t)`` (``obs.guard.RoundGuards``; None: unguarded).
    After every ``eval_every``-th round ``on_eval(t, metrics, chan, mask,
    eval_loss, eval_acc)``, outside the guards. Returns (wp, chans, Ws):
    the per-round channels and mixing matrices, the trajectory's
    epsilon input."""
    chans, Ws = [], []
    for t in range(rounds):
        batch = next(batches)
        if guards is None:
            wp, metrics, chan, mask, W = round_fn(wp, batch)
        else:
            with guards.round(t):
                wp, metrics, chan, mask, W = round_fn(wp, batch)
        chans.append(chan)
        Ws.append(W)
        if t % eval_every == 0 and on_eval is not None:
            ev_loss, ev_acc = evaluate(wp, eval_batch)
            on_eval(t, metrics, chan, mask, ev_loss, ev_acc)
    return wp, chans, Ws


def trajectory_report(proto, chans, Ws) -> dict:
    """The privacy trajectory: Theorem 4.1 on each realized round,
    composed worst-case across the run."""
    return P.epsilon_report(proto, stack_states(chans), Ws=torch.stack(Ws))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1-2. a federation on a dynamic network; data and model as in the
    # static quickstart
    proto, cfg, batcher, wp = setup(dev)
    sim = proto.simulator(dev)

    # 3. the dynamic round: the channel and W are arguments of the step
    gen = torch.Generator(device=dev).manual_seed(1)
    state = sim.init(gen)
    round_fn = network_round(P.make_dynamic_train_step(cfg, proto, dev),
                             sim, state, gen)
    source = HostBatches(batcher, dev)
    batches = (source.draw(gen) for _ in itertools.count())
    eval_batch = {k: torch.as_tensor(v, device=dev)
                  for k, v in batcher.full(128).items()}
    guards = RoundGuards(dev, label="dynamic")
    printed = []

    def on_eval(t, metrics, chan, mask, ev_loss, ev_acc):
        row = {"round": t, "c": float(chan.c), "active": int(mask.sum()),
               "train_loss": float(metrics["loss"]),
               "eval_acc": float(ev_acc)}
        printed.append(row)
        print(f"round {t:4d}  c={row['c']:6.2f}  active={row['active']}/{N}"
              f"  train_loss={row['train_loss']:.3f}  "
              f"eval_acc={row['eval_acc']:.3f}", flush=True)

    wp, chans, Ws = train(round_fn, P.make_eval_fn(cfg), wp, batches,
                          eval_batch, args.rounds, guards=guards,
                          on_eval=on_eval)

    # 4. privacy is a trajectory under a time-varying channel
    rep = trajectory_report(proto, chans, Ws)
    traj = rep["epsilon_per_round"]
    out = {"evals": printed, "rounds": rep["rounds"],
           "epsilon_min": float(traj.min()),
           "epsilon_mean": rep["epsilon_mean"],
           "epsilon_max": rep["epsilon_worst"],
           "epsilon_composed": rep["epsilon_trajectory_composed"],
           "delta_composed": rep["delta_trajectory_composed"],
           "ops_per_round": guards.ops, "guarded_rounds": guards.rounds,
           "state": {"wp": wp, "report": rep}}
    print(f"\nper-round eps over {rep['rounds']} rounds: "
          f"min={out['epsilon_min']:.3f} mean={out['epsilon_mean']:.3f} "
          f"max={out['epsilon_max']:.3f}")
    print(f"trajectory composition: eps={out['epsilon_composed']:.2f} "
          f"delta={out['delta_composed']:.1e}")
    print(f"guarded rounds: {guards.rounds} of {args.rounds}, each "
          f"{guards.ops} device operations, no host read, no kernel build "
          f"after round 0 ({len(chans)} channel realizations)")
    return out


if __name__ == "__main__":
    main()
