"""Hot-loop guards — the port of the reference's ``repro.obs.guard``.

``no_implicit_transfers`` is the reference's transfer guard mapped to
torch: ``torch.cuda.set_sync_debug_mode("error")`` around a block on a
CUDA device, so any call inside it that waits for the device (``.item()``,
``float()`` of a device tensor, a blocking copy) raises at its call site.
On the CPU it does nothing.

``retrace_guard`` keeps the reference's interface. The reference counts
compilations of jitted programs; the port compiles no program per chunk,
and what it can rebuild mid-run is a kernel library
(``kernels.build``): the guard counts library builds and loads
(``build.BUILDS``), and a chunk after the first must add none. A CUDA
graph capture (ROADMAP A7b) is counted the same way, by any object with a
``trace_counts()`` method.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional


@contextlib.contextmanager
def no_implicit_transfers(enabled: bool = True, device=None):
    """Make every device synchronization inside the block an error (on a
    CUDA ``device``, the current one when None), and restore the previous
    mode on exit, also on an exception. ``enabled=False`` is the opt-out
    (``--no-transfer-guard``). A no-op without a card; it does not touch
    ``torch.cuda`` on a CPU-only build."""
    import torch
    dev = None if device is None else torch.device(device)
    if (not enabled or (dev is not None and dev.type != "cuda")
            or not torch.cuda.is_available()):
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class RetraceError(AssertionError):
    """A guarded block rebuilt more often than allowed."""


class LibraryBuilds:
    """The count of kernel-library builds and loads in this process
    (``kernels.build.BUILDS``), as a watchable object."""

    def trace_counts(self) -> dict:
        from repro_torch.kernels import build
        return dict(build.BUILDS)


def _trace_count(obj) -> int:
    """Lifetime rebuild count of a watched object: anything with
    ``trace_counts()`` ({key: count})."""
    counts = getattr(obj, "trace_counts", None)
    if counts is None:
        raise TypeError(
            f"retrace_guard needs an object with trace_counts() (e.g. "
            f"LibraryBuilds()); got {type(obj).__name__}")
    return sum(counts().values())


class retrace_guard:
    """Context manager asserting at most ``max_new_traces`` rebuilds of
    the watched objects inside the block."""

    def __init__(self, *watched, max_new_traces: int = 0, label: str = "",
                 strict: bool = True,
                 on_retrace: Optional[Callable[[str], None]] = None):
        if not watched:
            raise ValueError("retrace_guard needs at least one object to "
                             "watch")
        self._watched = watched
        self.max_new_traces = int(max_new_traces)
        self.label = label
        self.strict = strict
        self._on_retrace = on_retrace
        self.new_traces = 0
        self.total_traces = 0
        self.violated = False

    def __enter__(self) -> "retrace_guard":
        self._before = sum(_trace_count(f) for f in self._watched)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.total_traces = sum(_trace_count(f) for f in self._watched)
        self.new_traces = self.total_traces - self._before
        if exc_type is not None:
            return False                     # never mask the block's error
        if self.new_traces > self.max_new_traces:
            self.violated = True
            msg = (f"retrace_guard{f' [{self.label}]' if self.label else ''}:"
                   f" {self.new_traces} rebuild(s) inside the guarded block "
                   f"(allowed {self.max_new_traces})")
            if self._on_retrace is not None:
                self._on_retrace(msg)
            if self.strict:
                raise RetraceError(msg)
        return False
