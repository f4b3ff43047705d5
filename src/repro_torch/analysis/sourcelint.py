"""AST source lint (the reference's ``repro.analysis.sourcelint``).

Each library module is parsed with ``ast`` and actual ``print(...)``
calls are flagged — structured output goes through repro_torch.obs
(runlog/console); an ad-hoc print in library code pollutes the logs of
every run that imports it.

Scope (library code only): everything under ``src/repro_torch`` EXCEPT

* ``launch/`` and ``obs/`` — the driver/reporting layers, whose job is
  to talk to the terminal;
* any ``__main__.py`` — CLI entry points (``repro_torch.analysis``
  itself, ``repro_torch.obs.report``) print their reports by design.

Findings share the analysis schema, so the CLI emits them into the same
JSON report and the same ERROR gate as the program checkers.
"""
from __future__ import annotations

import ast
import pathlib
from typing import List, Optional

from repro_torch.analysis.findings import Finding, Severity

CHECKER = "source-lint"

_SKIP_DIRS = ("launch", "obs")


def _lint_module(path: pathlib.Path, rel: str) -> List[Finding]:
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:  # a module that doesn't parse is its own ERROR
        return [Finding(CHECKER, Severity.ERROR, "source",
                        f"syntax error: {e.msg}",
                        where=f"{rel}:{e.lineno or 0}")]
    out: List[Finding] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            out.append(Finding(
                CHECKER, Severity.ERROR, "source",
                "stray print() in library code — route it through "
                "repro_torch.obs (runlog/console)",
                where=f"{rel}:{node.lineno}"))
    return out


def lint_source(root: Optional[pathlib.Path] = None) -> List[Finding]:
    """Lint every library module under ``src/repro_torch`` (see module
    docstring for the scope). ``root`` overrides the tree to scan —
    the tests point it at fixture trees."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[1]  # src/repro_torch
    root = pathlib.Path(root)
    findings: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        parts = path.relative_to(root).parts
        if parts and parts[0] in _SKIP_DIRS:
            continue
        if path.name == "__main__.py":
            continue
        findings.extend(_lint_module(path, rel))
    return findings
