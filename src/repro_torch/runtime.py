"""Device selection for the port's entry points, the CUDA graph capture
its two executors share (``core.trajectory.ChunkRunner``,
``launch.serve.DecodeRunner``), and the freeing of graphs that hold NCCL
collectives before a process group is destroyed."""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Any, Callable, Iterable, Tuple

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device asked for. Asking for CUDA on a machine without a
    card raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev


def capture_graph(fn: Callable[[], Any], stream, pool=None, *, what: str,
                  generators: Iterable[torch.Generator] = ()
                  ) -> Tuple[Any, Any]:
    """(graph, fn's result): ``fn()`` recorded as one CUDA graph on
    ``stream`` (a side stream, as capture needs), its memory from ``pool``
    (a new private pool when None), drawing from ``generators``. ``fn``
    runs no kernel build, module load or cuBLAS set-up: its caller ran it
    eagerly first. A capture synchronizes nothing, and any sync inside it
    fails the capture: the sync guard is off for its set-up (freeing the
    cache, so that the graph's pool can take the memory it needs). A
    capture that fails raises RuntimeError naming ``what`` and ROADMAP
    A7b; nothing falls back to the eager program."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        torch.cuda.empty_cache()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            ended = False
            try:
                graph.capture_begin(pool=pool)
                out = fn()
                ended = True
                graph.capture_end()
            except Exception as e:
                if not ended:
                    # the capture is broken already; end it all the same
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                raise RuntimeError(f"{what} could not be captured as a CUDA "
                                   f"graph (ROADMAP A7b): {e}") from e
        torch.cuda.current_stream().wait_stream(stream)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return graph, out


# the objects whose close() runs before a process group is destroyed
_CLOSE_BEFORE_DESTROY: "weakref.WeakSet" = weakref.WeakSet()


def close_before_destroy(holder) -> None:
    """Have ``holder.close()`` run whenever a process group is destroyed
    through ``torch.distributed.destroy_process_group``, for as long as
    ``holder`` lives. A CUDA graph that captured NCCL collectives keeps
    their communicator: NCCL's destroy waits for it forever while such a
    graph exists (two ranks hung there, PERF 6), so a holder of such
    graphs frees them first. torch has no hook for it: the first call
    wraps ``torch.distributed.destroy_process_group`` with one that
    closes every live holder, then destroys as before."""
    import torch.distributed as dist
    _CLOSE_BEFORE_DESTROY.add(holder)
    destroy = dist.destroy_process_group
    if getattr(destroy, "closes_holders", False):
        return

    @functools.wraps(destroy)
    def destroy_process_group(*args, **kwargs):
        for h in list(_CLOSE_BEFORE_DESTROY):
            h.close()
        return destroy(*args, **kwargs)

    destroy_process_group.closes_holders = True
    dist.destroy_process_group = destroy_process_group
