"""The shared Finding schema every repro_torch.analysis checker emits (a
copy of the reference's ``repro.analysis.findings``).

One checker = one pure function ``program run -> list[Finding]``; the CLI
(``python -m repro_torch.analysis``) concatenates the lists over the
registered driver programs, serializes them as one JSON report, and exits
non-zero iff any finding is ERROR severity.

Severity policy:

* ``ERROR``   — the invariant the paper's guarantee or the perf contract
                rests on is violated (a reused noise counter, a second
                carry buffer, a frozen channel realization on a dynamic
                path, an f64 op or a host read inside a round). CI fails.
* ``WARNING`` — suspicious but not provably wrong. Reported, CI passes.
* ``INFO``    — expected-by-construction facts worth surfacing (e.g. the
                static-channel path intentionally baking the one-shot
                realization into the program).
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Dict, List


class Severity(enum.IntEnum):
    """Ordered so max() over findings yields the binding severity."""
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR", in reports
        return self.name.lower()


@dataclass(frozen=True)
class Finding:
    """One checker hit on one program (or source file).

    ``checker``  — catalogue name ("key-discipline", "donation", ...).
    ``severity`` — Severity (see module docstring for the policy).
    ``program``  — registry program name, or "source" for the AST lint.
    ``message``  — one human-readable sentence.
    ``where``    — location: a round and op or kernel call ("round 1,
                   kernel dp_mix_round"), or "file.py:line" for source
                   findings.
    ``detail``   — JSON-able extras (shapes, counts, var names).
    """
    checker: str
    severity: Severity
    program: str
    message: str
    where: str = ""
    detail: Dict = field(default_factory=dict)

    def to_json(self) -> Dict:
        return {
            "checker": self.checker,
            "severity": str(self.severity),
            "program": self.program,
            "message": self.message,
            "where": self.where,
            "detail": self.detail,
        }

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return (f"{str(self.severity).upper():7s} {self.checker:16s} "
                f"{self.program}{loc}: {self.message}")


def summarize(findings: List[Finding]) -> Dict[str, int]:
    """{"error": n, "warning": n, "info": n} over a finding list."""
    out = {str(s): 0 for s in (Severity.ERROR, Severity.WARNING,
                               Severity.INFO)}
    for f in findings:
        out[str(f.severity)] += 1
    return out


def report_json(findings: List[Finding], programs: List[str],
                meta: Dict) -> str:
    """The CI artifact: meta + per-severity summary + every finding."""
    return json.dumps({
        "meta": meta,
        "programs": programs,
        "summary": summarize(findings),
        "findings": [f.to_json() for f in findings],
    }, indent=2)
