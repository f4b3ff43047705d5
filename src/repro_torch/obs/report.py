"""Run-log summarizer: ``python -m repro_torch.obs.report <dir> [--json
out]`` — the port of the reference's ``repro.obs.report``; it reads a run
directory written by either package.

Renders a run directory (obs.runlog.RunLog) — or a directory of runs —
into a human-readable table: manifest provenance, eval trajectory, the
per-round ε trajectory and its composed budget, telemetry extremes, and
every warning the watchdogs fired. ``--json`` additionally writes the
machine-readable summary (what the tables are printed from).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Any, Dict, List, Optional

from repro_torch.obs.runlog import RunLog, console


def _stats(vals: List[float]) -> Dict[str, float]:
    vs = [float(v) for v in vals if v is not None]
    if not vs:
        return {}
    return {"min": min(vs), "mean": sum(vs) / len(vs), "max": max(vs),
            "last": vs[-1], "n": len(vs)}


def summarize_run(run_dir) -> Dict[str, Any]:
    """Machine-readable summary of one run directory."""
    run_dir = pathlib.Path(run_dir)
    man = RunLog.read_manifest(run_dir)
    events = RunLog.read_events(run_dir)
    by_type: Dict[str, List[Dict]] = {}
    for e in events:
        by_type.setdefault(e.get("type", "?"), []).append(e)

    rounds = by_type.get("round", [])
    telemetry = {}
    skip = {"t", "type", "step"}
    for key in sorted({k for r in rounds for k in r} - skip):
        telemetry[key] = _stats([r.get(key) for r in rounds])

    evals = [{k: e.get(k) for k in ("step", "loss", "eval_loss", "eval_acc",
                                    "wall_s") if k in e}
             for e in by_type.get("eval", [])]
    eps_events = by_type.get("epsilon", [])
    eps = {}
    if eps_events:
        last = eps_events[-1]
        eps = {k: last.get(k) for k in ("step", "eps_round", "eps_composed",
                                        "delta_composed", "rounds",
                                        "eps_rdp", "accountant")
               if k in last}
        eps["per_round"] = _stats([e.get("eps_round") for e in eps_events])
    return {
        "dir": str(run_dir),
        "manifest": man,
        "event_counts": {k: len(v) for k, v in sorted(by_type.items())},
        "telemetry": telemetry,
        "evals": evals,
        "epsilon": eps,
        "warnings": [e for e in by_type.get("warning", [])],
        "compiles": len(by_type.get("compile", [])),
    }


def _fmt(v, width: int = 10) -> str:
    if isinstance(v, float):
        return f"{v:{width}.4g}"
    return f"{str(v):>{width}}"


def print_run(summary: Dict[str, Any]) -> None:
    man = summary["manifest"]
    console(f"run      {summary['dir']}")
    console(f"  kind={man.get('kind')} status={man.get('status')} "
            f"created={man.get('created')} wall={man.get('wall_s', '?')}s")
    console(f"  git={man.get('git_sha')} backend={man.get('backend')} "
            f"devices={man.get('device_count')} seed={man.get('seed')} "
            f"config_hash={man.get('config_hash')}")
    counts = " ".join(f"{k}:{n}" for k, n in summary["event_counts"].items())
    console(f"  events   {counts or '(none)'}")

    if summary["telemetry"]:
        console("  telemetry (per-round)")
        console(f"    {'field':>14} {'min':>10} {'mean':>10} {'max':>10} "
                f"{'last':>10} {'n':>6}")
        for name, st in summary["telemetry"].items():
            if not st:
                continue
            console(f"    {name:>14} {_fmt(st['min'])} {_fmt(st['mean'])} "
                    f"{_fmt(st['max'])} {_fmt(st['last'])} {st['n']:>6}")

    if summary["evals"]:
        console("  eval trajectory")
        console(f"    {'step':>8} {'loss':>10} {'eval_loss':>10} "
                f"{'eval_acc':>10}")
        for e in summary["evals"]:
            console(f"    {e.get('step', '?'):>8} {_fmt(e.get('loss', ''))} "
                    f"{_fmt(e.get('eval_loss', ''))} "
                    f"{_fmt(e.get('eval_acc', ''))}")

    if summary["epsilon"]:
        ep = summary["epsilon"]
        pr = ep.get("per_round") or {}
        console("  privacy")
        if pr:
            console(f"    eps/round   min={pr['min']:.4g} "
                    f"mean={pr['mean']:.4g} max={pr['max']:.4g} "
                    f"(checkpoints={pr['n']})")
        if ep.get("eps_composed") is not None:
            console(f"    composed    eps={ep['eps_composed']:.4g} "
                    f"delta={ep.get('delta_composed', float('nan')):.3g} "
                    f"over {ep.get('rounds', '?')} rounds")
        if ep.get("eps_rdp") is not None:
            console(f"    rdp         eps={ep['eps_rdp']:.4g} "
                    f"(accountant={ep.get('accountant', 'composition')})")

    if summary["warnings"]:
        console(f"  warnings ({len(summary['warnings'])})")
        for w in summary["warnings"]:
            console(f"    [t={w.get('t')}s] {w.get('message')}")
    console("")


def find_runs(base) -> List[pathlib.Path]:
    base = pathlib.Path(base)
    if RunLog.is_run_dir(base):
        return [base]
    if not base.is_dir():
        return []
    return sorted(p for p in base.iterdir() if RunLog.is_run_dir(p))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize run logs (repro_torch.obs or repro.obs)")
    ap.add_argument("dir", help="a run directory (manifest.json + "
                                "events.jsonl) or a directory of runs")
    ap.add_argument("--json", default=None,
                    help="also write the machine-readable summary here")
    args = ap.parse_args(argv)

    runs = find_runs(args.dir)
    if not runs:
        console(f"no runs found under {args.dir} (a run directory holds "
                f"manifest.json + events.jsonl)")
        return 1
    summaries = [summarize_run(r) for r in runs]
    for s in summaries:
        print_run(s)
    console(f"{len(summaries)} run(s) summarized")
    if args.json:
        out = summaries[0] if len(summaries) == 1 else {"runs": summaries}
        pathlib.Path(args.json).write_text(
            json.dumps(out, indent=2, default=str) + "\n")
        console(f"summary json -> {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
