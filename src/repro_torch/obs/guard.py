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
(``build.BUILDS``), and a chunk after the first must add none. The CUDA
graph captures of ``core.trajectory.ChunkRunner`` are counted the same
way, by its ``trace_counts()`` ({chunk length: captures}), as any object
with that method is.

``RoundOps`` counts the device operations a block dispatches and refuses
a host read inside it, on any device (the CPU too, where the sync-debug
mode does nothing); ``RoundGuards`` puts each round of a loop under
all three. Together they stand for the reference's "compiled exactly once"
asserts: an eager round cannot retrace, but it can read the host, build
a library, or change its work from one round to the next.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

from torch.utils._python_dispatch import TorchDispatchMode


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


class HostReadError(RuntimeError):
    """A guarded round read a device value on the host."""


class RoundOps(TorchDispatchMode):
    """Context manager counting the aten operations a block dispatches
    (views excluded: they launch nothing; each other op is one or more
    kernel launches on the card, the autograd engine's backward ops
    included) in ``n``, and raising ``HostReadError`` at a host read
    inside it: ``aten._local_scalar_dense`` (``.item()``, ``float()``,
    ``int()``, ``bool()`` of a tensor) and a copy from a CUDA tensor to
    the host. The hand kernels' launches go through ctypes and are not
    seen; their wrappers' allocations are."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        _refuse_host_read(func, args, kwargs)
        if not func.is_view:
            self.n += 1
        return func(*args, **kwargs)


def _refuse_host_read(func, args, kwargs) -> None:
    import torch
    aten = torch.ops.aten
    if func is aten._local_scalar_dense.default:
        raise HostReadError("a host read (.item(), float(), int() or bool() "
                            "of a tensor) inside a guarded round")
    if func in (aten._to_copy.default, aten.copy_.default):
        src = args[1] if func is aten.copy_.default else args[0]
        dst = (args[0].device if func is aten.copy_.default
               else kwargs.get("device"))
        if (isinstance(src, torch.Tensor) and src.device.type == "cuda"
                and dst is not None and torch.device(dst).type == "cpu"):
            raise HostReadError("a copy from the card to the host inside a "
                                "guarded round")


class RoundGuards:
    """The guards of a hot loop's rounds: ``round(t)`` is a context
    manager putting round t under ``no_implicit_transfers``, a
    ``RoundOps`` count that refuses host reads, and from round 1 on a
    ``retrace_guard`` over ``LibraryBuilds`` (a kernel library may be
    built in round 0 only). On leaving a round it checks that the round
    dispatched as many operations as round 0 (``ops``), and raises
    ``RetraceError`` otherwise: a round's work is a function of its
    shapes alone."""

    def __init__(self, device=None, label: str = ""):
        self.device = device
        self.label = label
        self.ops: Optional[int] = None
        self.rounds = 0

    @contextlib.contextmanager
    def round(self, t: int):
        with contextlib.ExitStack() as stack:
            stack.enter_context(no_implicit_transfers(True, self.device))
            if t > 0:
                stack.enter_context(retrace_guard(
                    LibraryBuilds(), label=f"{self.label} round {t}"))
            ops = stack.enter_context(RoundOps())
            yield
        if self.ops is None:
            self.ops = ops.n
        elif ops.n != self.ops:
            raise RetraceError(
                f"{self.label} round {t} dispatched {ops.n} operations, "
                f"round 0 {self.ops}: the round's work changed")
        self.rounds += 1
