"""CLI: check the shipped round programs and the library source.

    python -m repro_torch.analysis                     # on the card
    python -m repro_torch.analysis --device cpu --hidden 16
    python -m repro_torch.analysis --programs static-tree,fleet-flat
    python -m repro_torch.analysis --source-only       # AST lint only
    python -m repro_torch.analysis --json report.json

Runs on the card by default and raises without one. Exit status 1 iff
any finding is an ERROR. ``shard-flat-s2-mesh`` runs only in a two-rank
process group (``torchrun --nproc-per-node 2``); elsewhere it is
reported as skipped.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from repro_torch.analysis import (Severity, analyze_run, available_programs,
                                  build_programs, kernel_launches,
                                  lint_source, report_json, run_program,
                                  summarize)
from repro_torch.analysis.keys import (collect_draws, collect_stream_draws,
                                      counter_ranges)
from repro_torch.analysis.registry import HIDDEN, PROGRAMS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="checks of the DWFL round programs and the source")
    ap.add_argument("--programs", default=None,
                    help="comma-separated registry subset "
                         f"(default: all of {','.join(PROGRAMS)})")
    ap.add_argument("--source-only", action="store_true",
                    help="run only the AST source lint")
    ap.add_argument("--no-source", action="store_true",
                    help="skip the AST source lint")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only non-INFO findings and the summary")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--hidden", type=int, default=HIDDEN,
                    help="the programs' MLP width (dwfl-paper's: 256)")
    args = ap.parse_args(argv)

    t0 = time.time()
    findings, programs, launches = [], [], {}
    if not args.source_only:
        if args.programs:
            names = args.programs.split(",")
        else:
            names = available_programs()
            for skipped in [n for n in PROGRAMS if n not in names]:
                print(f"[analysis] {skipped}: skipped (needs a two-rank "
                      f"process group)")
        for name in names:
            t1 = time.time()
            prog, = build_programs([name], hidden=args.hidden,
                                   device=args.device)
            run = run_program(prog)
            fs = analyze_run(run)
            findings.extend(fs)
            programs.append(name)
            launches[name] = kernel_launches(run)
            ranges = counter_ranges(collect_draws(run))
            print(f"[analysis] {name}: {len(fs)} findings "
                  f"({time.time() - t1:.1f}s); kernel calls "
                  f"{json.dumps(launches[name])}; generator draws "
                  f"{len(collect_stream_draws(run))}; counter ranges "
                  f"{json.dumps(ranges[:4])}"
                  + (f" (+{len(ranges) - 4})" if len(ranges) > 4 else ""),
                  flush=True)
            del run, prog
    if not args.no_source:
        findings.extend(lint_source())
        programs.append("source")

    for f in findings:
        if not (args.quiet and f.severity == Severity.INFO):
            print(f)
    summary = summarize(findings)
    elapsed = time.time() - t0
    print(f"[analysis] {len(programs)} targets, {summary['error']} error / "
          f"{summary['warning']} warning / {summary['info']} info "
          f"({elapsed:.1f}s)")
    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report_json(
            findings, programs,
            meta={"elapsed_s": round(elapsed, 1), "argv": list(argv or []),
                  "device": args.device, "hidden": args.hidden,
                  "kernel_calls": launches}))
        print(f"[analysis] report -> {out}")
    return 1 if summary["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
