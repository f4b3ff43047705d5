"""Cost of an eager program from what ``utils.trace.Recorder`` saw — the
port's counterpart of the reference's loop-aware HLO cost
(``repro.utils.hlo_cost``, with ``repro.utils.hlo``'s ring factors).

* **FLOPs**: ``torch.utils.flop_counter``'s registered formulas for the
  GEMM-family ops (mm, bmm, addmm, baddbmm, convolution, the fused
  attentions), plus each hand kernel's declared work
  (``kernels.work``). Elementwise and other ops add bytes only, and their
  records say so (``kind`` "bytes-only"). Each FLOP goes to a compute
  class (``utils.roofline``): a GEMM's by its dtype, float32 at the
  CUDA cores' rate unless TF32 is allowed for matmuls, a kernel's by
  its route.
* **Bytes**: the sum over every non-view op of its tensor inputs (each
  read once; an ``out=`` argument is only written) and its outputs (each
  written once; an in-place op's output is the argument it writes, not
  counted twice). Eager PyTorch fuses nothing, so this is the traffic the
  program really issues: the analogue of hlo_cost's top-level ops, with
  ``_SKIP_BYTES``' role played by the view and alias ops and the
  allocations (``ZERO_BYTE_OPS``). A kernel's aten ops inside its
  wrapper are not counted: its declared bytes stand for them.
* **Collective link bytes**: each recorded collective's bytes times the
  ring factor of its group size g (``RING_FACTOR``, the reference's
  ``_ALGO_FACTOR``); a broadcast or point-to-point send moves its bytes
  once. A group of one rank moves nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch

RING_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

_aten = torch.ops.aten
# ops that move no tensor data: allocations, aliasing, metadata
ZERO_BYTE_OPS = frozenset({
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten.detach.default, _aten.alias.default,
    _aten.set_.source_Storage_storage_offset, _aten.resize_.default,
})


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def compute_class(dtype: torch.dtype) -> str:
    """The roofline class of a GEMM in ``dtype``."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "f32"


_SCHEMA: Dict = {}


def _write_only(func):
    """(positional flags, keyword names) of an op's write-only ``out=``
    arguments, worked out once an op."""
    info = _SCHEMA.get(func)
    if info is None:
        flags, names = [], set()
        for a in func._schema.arguments:
            alias = a.alias_info
            w = alias is not None and alias.is_write and a.kwarg_only
            flags.append(w)
            if w:
                names.add(a.name)
        info = _SCHEMA[func] = (flags, names)
    return info


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves (the module docstring's rule)."""
    if func.is_view or func in ZERO_BYTE_OPS:
        return 0
    seen = set()
    total = 0
    flags, names = _write_only(func)
    pairs = [(i < len(flags) and flags[i], v) for i, v in enumerate(args)]
    pairs += [(k in names, v) for k, v in kwargs.items()]
    for write_only, value in pairs:
        for t in _tensors(value):
            if write_only or id(t) in seen:
                continue
            seen.add(id(t))
            total += nbytes(t)
    written = set()
    for t in _tensors(out):
        if id(t) not in written:
            written.add(id(t))
            total += nbytes(t)
    return total


def op_flops(func, args, kwargs, out):
    """(FLOPs, compute class) of one aten op: flop_counter's formula where
    it has one, else (0, None): the op adds bytes only."""
    reg = _flop_registry()
    packet = func._overloadpacket
    if packet not in reg:
        return 0, None
    flops = reg[packet](*args, **kwargs, out_val=out)
    first = next(_tensors(args), None)
    return int(flops), compute_class(first.dtype if first is not None
                                     else torch.float32)


@dataclass
class Cost:
    """Totals of one recorded program: FLOPs by compute class, bytes, the
    collectives' raw and link bytes, and counts."""
    flops_by_class: Dict[str, int] = field(default_factory=dict)
    bytes: int = 0
    link_bytes: float = 0.0
    n_ops: int = 0
    n_flop_ops: int = 0
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    kernel_flops: int = 0
    kernel_bytes: int = 0
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_raw: Dict[str, int] = field(default_factory=dict)

    @property
    def flops(self) -> int:
        return sum(self.flops_by_class.values())

    def add_flops(self, flops: float, cls: str) -> None:
        if flops:
            self.flops_by_class[cls] = self.flops_by_class.get(cls, 0) + flops

    def add_op(self, flops: float, cls, nbytes_: float) -> None:
        self.n_ops += 1
        if cls is not None:
            self.n_flop_ops += 1
            self.add_flops(flops, cls)
        self.bytes += nbytes_

    def add_kernel(self, name: str, work) -> None:
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self.add_flops(work.flops, work.compute_class)
        self.kernel_flops += work.flops
        self.kernel_bytes += work.nbytes
        self.bytes += work.nbytes

    def add_collective(self, op: str, raw: float, group_size: int) -> None:
        self.collective_counts[op] = self.collective_counts.get(op, 0) + 1
        self.collective_raw[op] = self.collective_raw.get(op, 0) + raw
        if group_size > 1:
            self.link_bytes += raw * RING_FACTOR[op](group_size)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "flops_by_class": self.flops_by_class,
                "bytes": self.bytes, "link_bytes": self.link_bytes,
                "n_ops": self.n_ops, "n_flop_ops": self.n_flop_ops,
                "kernel_calls": self.kernel_calls,
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "collective_counts": self.collective_counts,
                "collective_raw": self.collective_raw}


def count(fn, *args, **kwargs):
    """(fn's result, its Cost): ``fn(*args, **kwargs)`` run once under a
    recorder that keeps no per-op records."""
    from repro_torch.utils.trace import Recorder
    with Recorder(keep_ops=False) as rec:
        out = fn(*args, **kwargs)
    return out, rec.cost
