"""Structured run logs — the host half of ``repro_torch.obs``, the port of
the reference's ``repro.obs.runlog`` in the same format, so either
package's ``report`` reads either package's runs.

Every driver invocation (launch/train.py, fleet/sweep.py) opens a RUN: a
directory holding

    manifest.json    who/what/where — git SHA, backend, device count,
                     config + config hash, seed, argv, wall-clock; the
                     reference's keys ("jax" is null here) and "torch"
                     and "device_name"
    events.jsonl     append-only machine-readable event stream: per-round
                     telemetry rows, eval results, checkpoint saves,
                     ε-budget checkpoints, compile/retrace events,
                     watchdog warnings, the closing status

so a run is reproducible and comparable from its directory alone — the
run-level analogue of the MLPerf workload convention the benchmarks
follow. ``python -m repro_torch.obs.report <dir>`` renders a run (or a
tree of runs) into a human-readable summary.

Watchdogs (host-side, fed by the in-scan telemetry):

    EpsilonBudgetWatchdog   warns ONCE when the composed trajectory ε
                            crosses a configured fraction of the budget,
                            and once more when it exceeds the budget
    RetraceWatchdog         tracks rebuild counts (obs.guard's
                            ``trace_counts()``: kernel-library builds and
                            loads) across chunks and warns when one grows
                            AFTER its first appearance

Writing is fail-safe cheap: one ``json.dumps`` + file append per event at
chunk/eval cadence — never per round inside the hot loop (per-round rows
arrive as one stacked array per chunk and are written at the boundary).
"""
from __future__ import annotations

import getpass
import hashlib
import json
import os
import pathlib
import platform
import socket
import subprocess
import sys
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

MANIFEST = "manifest.json"
EVENTS = "events.jsonl"


def console(msg: str) -> None:
    """User-facing console line. All printing outside launch/ flows
    through here."""
    print(msg, flush=True)


def git_sha(root: Optional[str] = None) -> str:
    """Current commit SHA (+'-dirty' when the tree has changes), or
    'unknown' outside a git checkout — never raises."""
    try:
        here = root or os.path.dirname(os.path.abspath(__file__))
        sha = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"], cwd=here,
            capture_output=True, text=True, timeout=10).stdout.strip()
        if not sha:
            return "unknown"
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=here,
            capture_output=True, text=True, timeout=10).stdout.strip()
        return sha + ("-dirty" if dirty else "")
    except Exception:
        return "unknown"


def config_hash(config: Any) -> str:
    """Stable short hash of a JSON-able config (sorted keys, so dict
    ordering can't change the identity)."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _jsonable(v):
    """Best-effort scalarization for event payloads (np/jnp scalars and
    0-d arrays -> float/int; small arrays -> lists)."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    return v


class RunLog:
    """One open run directory: a manifest plus an append-only JSONL
    event stream. Use as a context manager or call ``close()``."""

    def __init__(self, run_dir: pathlib.Path, manifest: Dict[str, Any]):
        self.dir = pathlib.Path(run_dir)
        self.manifest = manifest
        self._events_path = self.dir / EVENTS
        self._t0 = time.time()
        self._f = open(self._events_path, "a")
        self.n_events = 0
        self.n_warnings = 0
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def open(cls, run_dir, *, kind: str = "run", config: Any = None,
             seed: Optional[int] = None, argv: Optional[Iterable[str]] = None,
             extra: Optional[Dict[str, Any]] = None) -> "RunLog":
        """Open ``run_dir`` as a run (created if missing). The manifest
        captures provenance at open time; ``close()`` appends wall-clock
        and final status."""
        run_dir = pathlib.Path(run_dir)
        run_dir.mkdir(parents=True, exist_ok=True)
        manifest: Dict[str, Any] = {
            "kind": kind,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "created_unix": time.time(),
            "git_sha": git_sha(),
            "backend": _backend(),
            "device_count": _device_count(),
            "hostname": socket.gethostname(),
            "user": _user(),
            "platform": platform.platform(),
            "python": platform.python_version(),
            "jax": None,
            "torch": _torch_version(),
            "device_name": _device_name(),
            "pid": os.getpid(),
            "argv": list(argv) if argv is not None else sys.argv[1:],
            "seed": seed,
            "config": config,
            "config_hash": config_hash(config) if config is not None else None,
            "status": "open",
        }
        if extra:
            manifest.update(extra)
        (run_dir / MANIFEST).write_text(json.dumps(manifest, indent=2,
                                                   default=str) + "\n")
        return cls(run_dir, manifest)

    @classmethod
    def open_under(cls, base_dir, *, kind: str = "run", **kw) -> "RunLog":
        """Open a fresh uniquely-named run directory under ``base_dir``
        (``<kind>-<UTC timestamp>-<pid>``) — what the CLI drivers use so
        repeated invocations with one --runlog-dir never collide."""
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        name = f"{kind}-{stamp}-{os.getpid()}"
        run_dir = pathlib.Path(base_dir) / name
        n = 0
        while run_dir.exists():              # same second, same pid: rare
            n += 1
            run_dir = pathlib.Path(base_dir) / f"{name}.{n}"
        return cls.open(run_dir, kind=kind, **kw)

    def close(self, status: str = "ok", **summary) -> None:
        if self._closed:
            return
        self.event("close", status=status, **summary)
        self._f.close()
        self.manifest["status"] = status
        self.manifest["wall_s"] = round(time.time() - self._t0, 3)
        self.manifest["n_events"] = self.n_events
        self.manifest["n_warnings"] = self.n_warnings
        (self.dir / MANIFEST).write_text(
            json.dumps(self.manifest, indent=2, default=str) + "\n")
        self._closed = True

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close(status="ok" if exc_type is None else "error")
        return False

    # -- event stream ------------------------------------------------------

    def event(self, type_: str, **fields) -> Dict[str, Any]:
        """Append one JSONL event: {"t": seconds-since-open, "type": ...}."""
        rec = {"t": round(time.time() - self._t0, 3), "type": type_}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        self._f.write(json.dumps(rec, default=str) + "\n")
        self._f.flush()
        self.n_events += 1
        return rec

    def round_metrics(self, step: int, **fields) -> Dict[str, Any]:
        return self.event("round", step=step, **fields)

    def eval_metrics(self, step: int, **fields) -> Dict[str, Any]:
        return self.event("eval", step=step, **fields)

    def epsilon(self, step: int, **fields) -> Dict[str, Any]:
        """ε-budget checkpoint (composed trajectory budget so far)."""
        return self.event("epsilon", step=step, **fields)

    def checkpoint(self, path: str, step: int, **fields) -> Dict[str, Any]:
        return self.event("checkpoint", path=str(path), step=step, **fields)

    def compile_event(self, what: str, **fields) -> Dict[str, Any]:
        return self.event("compile", what=what, **fields)

    def warn(self, message: str, **fields) -> Dict[str, Any]:
        self.n_warnings += 1
        return self.event("warning", message=message, **fields)

    # -- readers (report / tests) -----------------------------------------

    @staticmethod
    def read_manifest(run_dir) -> Dict[str, Any]:
        return json.loads((pathlib.Path(run_dir) / MANIFEST).read_text())

    @staticmethod
    def read_events(run_dir, type_: Optional[str] = None) -> List[Dict]:
        path = pathlib.Path(run_dir) / EVENTS
        if not path.exists():
            return []
        out = []
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            if type_ is None or rec.get("type") == type_:
                out.append(rec)
        return out

    @staticmethod
    def is_run_dir(path) -> bool:
        return (pathlib.Path(path) / MANIFEST).is_file()


# -- watchdogs -------------------------------------------------------------


class EpsilonBudgetWatchdog:
    """Warn when the composed trajectory ε approaches/exceeds a budget.

    ``check(eps, step)`` fires at most two warnings over a run's life:
    once when ε first crosses ``frac``·budget ("approaching"), once when
    it first crosses the budget itself ("exceeded"). Returns the list of
    warnings fired by this call (empty when quiet), and forwards them to
    ``on_warn`` (e.g. RunLog.warn) when given."""

    def __init__(self, budget: float, frac: float = 0.8,
                 on_warn: Optional[Callable[..., Any]] = None):
        if budget <= 0:
            raise ValueError(f"epsilon budget must be > 0, got {budget}")
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"budget fraction must be in (0, 1], got {frac}")
        self.budget = float(budget)
        self.frac = float(frac)
        self._on_warn = on_warn
        self.warned_frac = False
        self.warned_budget = False

    def check(self, eps: float, step: Optional[int] = None) -> List[str]:
        eps = float(eps)
        fired = []
        if not self.warned_frac and eps >= self.frac * self.budget:
            self.warned_frac = True
            fired.append(
                f"epsilon budget: composed eps={eps:.4g} crossed "
                f"{self.frac:.0%} of budget {self.budget:.4g}")
        if not self.warned_budget and eps >= self.budget:
            self.warned_budget = True
            fired.append(
                f"epsilon budget EXCEEDED: composed eps={eps:.4g} > "
                f"budget {self.budget:.4g}")
        for msg in fired:
            if self._on_warn is not None:
                self._on_warn(msg, step=step, eps=eps, budget=self.budget)
        return fired


class RetraceWatchdog:
    """Warn when something rebuilds AFTER its first build.

    Give it anything obs.guard can count (an object with
    ``trace_counts()``, e.g. ``guard.LibraryBuilds()``); call
    ``check(step)`` at chunk/eval boundaries. The first time a key
    appears its count is recorded as an info event; any later growth of
    an existing key's count is a warning."""

    def __init__(self, *watched, runlog: Optional[RunLog] = None,
                 label: str = "step"):
        if not watched:
            raise ValueError("RetraceWatchdog needs something to watch")
        self._watched = watched
        self._runlog = runlog
        self.label = label
        self._seen: Dict[Any, int] = {}
        self.retraces = 0

    def _counts(self) -> Dict[Any, int]:
        counts: Dict[Any, int] = {}
        for i, w in enumerate(self._watched):
            tc = getattr(w, "trace_counts", None)
            if tc is None:
                raise TypeError(f"RetraceWatchdog needs objects with "
                                f"trace_counts(); got {type(w).__name__}")
            for k, v in tc().items():
                counts[(i, k)] = v
        return counts

    def check(self, step: Optional[int] = None) -> int:
        """Returns the number of NEW after-warmup retraces this call."""
        new_retraces = 0
        for key, n in self._counts().items():
            prev = self._seen.get(key)
            if prev is None:
                if self._runlog is not None:
                    self._runlog.compile_event(
                        f"{self.label}[{key[1]}]", step=step, traces=n)
                self._seen[key] = n
            elif n > prev:
                new_retraces += n - prev
                self._seen[key] = n
                msg = (f"retrace after warmup: {self.label}[{key[1]}] "
                       f"compiled {n - prev} more time(s) at step {step} "
                       f"(total {n})")
                if self._runlog is not None:
                    self._runlog.warn(msg, step=step)
        self.retraces += new_retraces
        return new_retraces


# -- provenance of the torch runtime --------------------------------------


def _backend() -> str:
    import torch
    return "gpu" if torch.cuda.is_available() else "cpu"


def _device_count() -> Optional[int]:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _torch_version() -> str:
    import torch
    return torch.__version__


def _device_name() -> str:
    import torch
    return (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")


def _user() -> str:
    try:
        return getpass.getuser()
    except Exception:
        return "unknown"
