"""ScenarioGrid — the cartesian sweep driver over the fleet, the port of
the reference's ``repro.fleet.sweep``.

A grid point is one (scenario, N, p_dbm, target_epsilon) cell; each cell
runs R replicates through one fleet round a step (``FleetEngine``: the
replicate axis carries the seeds), trains the reduced task, and reports
across-replicate mean and 95% CI of loss, accuracy and the composed
privacy budget. The rows aggregate into a JSON document with the
reference's keys (``run_grid(..., json_path=...)``).

    python -m repro_torch.fleet.sweep --scenarios iot_dense,vehicular \\
        --workers 8,16 --epsilon 0.5,1.0 --replicates 8 --steps 40

Runs on the card by default and raises without one; ``--device cpu``
runs the plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import DWFL_PAPER
from repro_torch.core import exchange as X
from repro_torch.core import protocol as P
from repro_torch.data import (FederatedBatcher, classification_dataset,
                              dirichlet_partition)
from repro_torch.fleet.engine import (FleetEngine, fleet_epsilon_report,
                                      fleet_eval, mean_ci, stack_rounds)
from repro_torch.models import mlp
from repro_torch.runtime import resolve_device

# the reduced task, the reference's (a copy: the port imports nothing of
# the reference package)
INPUT_DIM = 64
HIDDEN = 32
BATCH = 16
DATA_N = 2000


@dataclass(frozen=True)
class ScenarioGrid:
    """Cartesian product of scenario presets x worker counts x transmit
    powers x per-round privacy targets, each cell replicated R ways."""
    scenarios: Tuple[str, ...] = ("static_paper", "iot_dense")
    n_workers: Tuple[int, ...] = (8,)
    p_dbm: Tuple[float, ...] = (60.0,)
    target_epsilon: Tuple[float, ...] = (1.0,)
    replicates: int = 8
    steps: int = 40
    gamma: float = 0.02
    eta: float = 0.4
    clip: float = 1.0
    coherence_rounds: int = 0
    seed: int = 0
    # the ledger quoted per cell ("composition" | "rdp"); rows carry both
    accountant: str = "composition"

    def points(self):
        for scn, n, p, eps in itertools.product(
                self.scenarios, self.n_workers, self.p_dbm,
                self.target_epsilon):
            yield {"scenario": scn, "n_workers": n, "p_dbm": p,
                   "target_epsilon": eps}

    def size(self) -> int:
        return (len(self.scenarios) * len(self.n_workers) * len(self.p_dbm)
                * len(self.target_epsilon))


def cell_seed(base_seed: int, point: Dict) -> int:
    """A cell's own seed: a stable hash of (base seed, cell settings), the
    reference's, so a row is reproducible alone and independent of the
    cells' order."""
    blob = json.dumps({"seed": base_seed, **point}, sort_keys=True,
                      default=str)
    return int.from_bytes(hashlib.sha256(blob.encode()).digest()[:4],
                          "big") % (2 ** 31)


def _setup_fleet_task(fleet: FleetEngine, seed: int):
    """The reduced classification task, replicated: R host batch streams
    (their own shuffle seeds) over one dataset and partition, stacked to
    [R, W, B, ...] a round and uploaded."""
    proto, dev = fleet.proto, fleet.device
    cfg = dataclasses.replace(DWFL_PAPER, d_model=HIDDEN)
    x, y = classification_dataset(DATA_N, input_dim=INPUT_DIM, seed=seed)
    parts = dirichlet_partition(y, proto.n_workers, alpha=0.5, seed=seed)
    batchers = [FederatedBatcher(x, y, parts, batch_size=BATCH, seed=seed + r)
                for r in range(fleet.replicates)]

    def next_batch():
        draws = [b.next() for b in batchers]
        return {k: torch.as_tensor(np.stack([d[k] for d in draws]),
                                   device=dev) for k in draws[0]}

    def full_batch(n):
        one = batchers[0].full(n)
        return {k: torch.as_tensor(v, device=dev).expand(
                    (fleet.replicates,) + v.shape) for k, v in one.items()}

    def init_fleet_params(generator):
        """[R, W, ...]: each replicate's own common start (the MLP takes
        the task's input width)."""
        inits = [mlp.init(generator, cfg, input_dim=INPUT_DIM, device=dev)
                 for _ in range(fleet.replicates)]
        return X.tree_map(lambda *ls: torch.stack(ls)[:, None].expand(
            (len(ls), proto.n_workers) + tuple(ls[0].shape)).contiguous(),
            *inits)

    return cfg, next_batch, full_batch, init_fleet_params


def run_point(grid: ScenarioGrid, point: Dict, seed: int = 0,
              transfer_guard: bool = True, device="cuda") -> Dict:
    """One grid cell: R replicates through one fleet round a step. Returns
    the cell's row: its settings, its seed, the resolved protocol and
    scenario, and across-replicate aggregates. The timed loop runs under
    ``obs.no_implicit_transfers``: a host synchronization in the round
    would corrupt ``us_per_round``, so it fails instead."""
    dev = resolve_device(device)
    proto = P.ProtocolConfig(
        scheme="dwfl", n_workers=point["n_workers"], gamma=grid.gamma,
        eta=grid.eta, clip=grid.clip, p_dbm=point["p_dbm"], seed=seed,
        target_epsilon=point["target_epsilon"], channel_model="dynamic",
        scenario=point["scenario"], coherence_rounds=grid.coherence_rounds,
        replicates=grid.replicates, accountant=grid.accountant)
    fleet = FleetEngine(proto, device=dev)
    cfg, next_batch, full_batch, init_params = _setup_fleet_task(fleet, seed)
    fleet_round = fleet.make_fleet_round(cfg)
    evaluate = P.make_eval_fn(cfg)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    states = fleet.init(gen)
    wp = init_params(gen)

    chan_log, w_log = [], []
    # warm-up outside the timed loop
    states, wp, _, chans, Ws = fleet_round(gen, states, wp, next_batch())
    chan_log.append(chans)
    w_log.append(Ws)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(grid.steps):
        # the upload stays outside the guard; the round is device work only
        batch = next_batch()
        with obs.no_implicit_transfers(transfer_guard, dev):
            states, wp, _, chans, Ws = fleet_round(gen, states, wp, batch)
        chan_log.append(chans)
        w_log.append(Ws)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    us_per_round = (time.perf_counter() - t0) / grid.steps * 1e6

    ev_loss, ev_acc = fleet_eval(evaluate, wp, full_batch(128))   # [R]
    eps_rep = fleet_epsilon_report(
        proto, stack_rounds(chan_log), stack_rounds(w_log))

    loss_mean, loss_ci = mean_ci(ev_loss.cpu().numpy())
    acc_mean, acc_ci = mean_ci(ev_acc.cpu().numpy())
    return {
        **point,
        "seed": seed,
        "replicates": grid.replicates,
        "steps": grid.steps,
        "config": {"protocol": asdict(proto),
                   "scenario": asdict(fleet.sim.scenario)},
        "us_per_round": us_per_round,
        "loss_mean": loss_mean, "loss_ci95": loss_ci,
        "acc_mean": acc_mean, "acc_ci95": acc_ci,
        "epsilon_composed_mean": eps_rep["epsilon_composed_mean"],
        "epsilon_composed_ci95": eps_rep["epsilon_composed_ci95"],
        "epsilon_round_worst": eps_rep["epsilon_worst"],
        "delta_composed": eps_rep["delta_composed"],
        "epsilon_rdp_mean": eps_rep["epsilon_rdp_mean"],
        "epsilon_total_mean": eps_rep["epsilon_total_mean"],
        "epsilon_total_ci95": eps_rep["epsilon_total_ci95"],
        "delta_total": eps_rep["delta_total"],
        "accountant": grid.accountant,
        "accountant_gap": eps_rep["accountant_gap"],
    }


def run_grid(grid: ScenarioGrid, seed: Optional[int] = None,
             json_path: Optional[str] = None, verbose: bool = False,
             runlog: Optional[obs.RunLog] = None,
             transfer_guard: bool = True, device="cuda") -> Dict:
    """Sweep every cell; returns {"grid": settings, "rows": [cell rows]}
    and optionally writes it as JSON. Each cell runs under its own seed
    (``cell_seed(base, point)``); ``runlog`` records one "cell" event a
    row."""
    base = grid.seed if seed is None else seed
    rows: List[Dict] = []
    for point in grid.points():
        row = run_point(grid, point, seed=cell_seed(base, point),
                        transfer_guard=transfer_guard, device=device)
        rows.append(row)
        if runlog is not None:
            runlog.event("cell", **{k: v for k, v in row.items()
                                    if k != "config"})
        if verbose:
            obs.console(
                f"[sweep] {row['scenario']} N={row['n_workers']} "
                f"P={row['p_dbm']}dBm eps={row['target_epsilon']} "
                f"seed={row['seed']}: "
                f"acc={row['acc_mean']:.3f}±{row['acc_ci95']:.3f} "
                f"eps_T={row['epsilon_composed_mean']:.3g}"
                f"±{row['epsilon_composed_ci95']:.2g} "
                f"rdp={row['epsilon_rdp_mean']:.3g} "
                f"({row['us_per_round']:.0f}us/round x R={row['replicates']})")
    out = {"grid": asdict(grid), "rows": rows}
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
        if verbose:
            obs.console(f"[sweep] wrote {len(rows)} cells -> {json_path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet.sweep")
    ap.add_argument("--scenarios", default="static_paper,iot_dense")
    ap.add_argument("--workers", default="8")
    ap.add_argument("--p-dbm", default="60")
    ap.add_argument("--epsilon", default="1.0")
    ap.add_argument("--replicates", type=int, default=8)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accountant", default="composition",
                    choices=["composition", "rdp"],
                    help="ledger quoted per cell (rows always carry "
                         "both composed and rdp budgets + the gap)")
    ap.add_argument("--no-transfer-guard", action="store_true",
                    help="time the cells without torch.cuda."
                         "set_sync_debug_mode('error')")
    ap.add_argument("--json", default=None)
    ap.add_argument("--runlog-dir", default=None,
                    help="open a run log under this directory (one "
                         "'cell' event per grid cell)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    grid = ScenarioGrid(
        scenarios=tuple(args.scenarios.split(",")),
        n_workers=tuple(int(v) for v in args.workers.split(",")),
        p_dbm=tuple(float(v) for v in args.p_dbm.split(",")),
        target_epsilon=tuple(float(v) for v in args.epsilon.split(",")),
        replicates=args.replicates, steps=args.steps, seed=args.seed,
        accountant=args.accountant)
    resolve_device(args.device)
    runlog = None
    if args.runlog_dir is not None:
        runlog = obs.RunLog.open_under(args.runlog_dir, kind="sweep",
                                       config=asdict(grid), seed=args.seed,
                                       argv=argv)
        obs.console(f"[sweep] run log -> {runlog.dir}")
    out = run_grid(grid, json_path=args.json, verbose=True, runlog=runlog,
                   transfer_guard=not args.no_transfer_guard,
                   device=args.device)
    if runlog is not None:
        runlog.close("ok", cells=grid.size())
    return out


if __name__ == "__main__":
    main()
