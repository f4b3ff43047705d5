"""One recorder over a block of eager code, read by the cost count
(``utils.op_cost``) and the static checks (``repro_torch.analysis``):
the port's counterpart of the reference's jaxpr walk
(``repro.analysis.walk``) and HLO parsing (``repro.utils.hlo``).

    with Recorder() as rec:
        carry, out = body(carry)
    rec.cost, rec.ops, rec.kernels, rec.collectives, rec.peak_bytes

It records, on any device:

* every aten op, through a ``TorchDispatchMode`` (the autograd engine's
  backward ops too): its inputs' and outputs' shapes, dtypes and devices,
  whether it is a view or writes an argument in place, and its cost;
* every hand-kernel call (``kernel_call``, opened by each wrapper of
  ``repro_torch.kernels``): its name, its arguments, its declared work
  (``kernels.work``) and the counter-hash noise it draws (``Draw``). The
  aten ops the wrapper runs inside (its plain twin on the CPU or the meta
  device, its output allocation on the card) are not recorded, so a
  program counts the same on every device;
* every draw from a ``torch.Generator`` (``StreamDraw``: an aten op
  given a generator, as ``torch.randn(..., generator=g)`` is): the
  generator's seed and a digest of its state before the draw, read on
  the host (a CUDA generator keeps its seed and offset there), kept with
  the per-op records and not on the meta device, where a draw advances
  nothing;
* every ``torch.distributed`` collective the port calls (``all_reduce``,
  ``broadcast``, ``all_to_all_single``, the all-gathers,
  ``reduce_scatter_tensor``, ``batch_isend_irecv``), through patches of
  ``torch.distributed`` that leaving the block undoes, on an exception
  too;
* the live bytes of every tensor storage made inside the block (and of
  those handed to ``track``), through a finalizer on each storage, and
  their peak. A kernel's own temporaries are not seen; its outputs are.

``keep_ops=False`` keeps the totals and drops the per-op records (a dry
run at full size issues millions of ops). The recorder infers the output
of the commonest pointwise ops on meta tensors in Python (a broadcast
shape, the promoted dtype, a contiguous layout) instead of through
PyTorch's Python reference implementations, which cost ~200 us an op; it
does so only where every tensor operand is a meta tensor, and all are
contiguous (then the output is) or there is one (then the output takes
its layout, as ``empty_like`` does), where those rules are the op's own.
On the CPU and the card every op runs as it is.
"""
from __future__ import annotations

import hashlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.utils import op_cost

_STACK: List["Recorder"] = []


def active() -> Optional["Recorder"]:
    """The innermost open recorder, or None."""
    return _STACK[-1] if _STACK else None


@dataclass
class Draw:
    """One counter-hash noise draw. ``kind`` "mix": dp_mix's normals over
    rows [row0, row0 + rows) and columns [col0, col0 + cols) with row
    stride ``counter_width``, fields ``fields`` (counters 2 idx + field);
    "perturb": dp_perturb's Box-Muller normals of elements [0, numel).
    ``seed`` is an int or an int32 tensor, read only after the block
    (reading it inside would be a host sync); ``replicate`` is the
    fleet's replicate index, whose seed is ``seed[replicate]``."""
    kind: str
    seed: Any
    rows: int = 0
    cols: int = 0
    counter_width: int = 0
    row0: int = 0
    col0: Any = 0
    fields: Tuple[int, ...] = (0, 1)
    numel: int = 0
    replicate: Optional[int] = None
    call: int = -1


@dataclass
class StreamDraw:
    """One draw from a torch.Generator: the op, the generator's initial
    seed and a digest of its state just before the draw. Two draws that
    start from one state draw the same numbers."""
    op: str
    seed: int
    state: bytes
    numel: int
    index: int = 0


def _state_digest(gen: torch.Generator) -> bytes:
    return hashlib.blake2b(gen.get_state().numpy().tobytes(),
                           digest_size=16).digest()


@dataclass
class KernelRecord:
    name: str
    work: Any
    args: Dict[str, Any] = field(default_factory=dict)
    draws: List[Draw] = field(default_factory=list)
    index: int = 0          # position among the block's ops and kernels


@dataclass
class OpRecord:
    name: str
    in_shapes: List[Tuple[int, ...]]
    in_dtypes: List[torch.dtype]
    in_devices: List[str]
    out_shapes: List[Tuple[int, ...]]
    out_dtypes: List[torch.dtype]
    out_devices: List[str]
    is_view: bool
    inplace: bool
    flops: int
    compute_class: Optional[str]
    nbytes: int
    index: int = 0

    @property
    def kind(self) -> str:
        return "flops" if self.compute_class is not None else "bytes-only"


@dataclass
class CollectiveRecord:
    op: str               # all-reduce, all-gather, all-to-all, ...
    fn: str               # the torch.distributed function called
    in_shapes: List[Tuple[int, ...]]
    out_shapes: List[Tuple[int, ...]]
    raw_bytes: int
    group_size: int
    index: int = 0


class _NullCall:
    """The call context without a recorder: false, so a wrapper skips
    building its report (``if call: call.report(...)``)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self) -> bool:
        return False


_NULL = _NullCall()


class _KernelCall:
    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name
        self.record: Optional[KernelRecord] = None

    def __enter__(self):
        self.rec._kernel_depth += 1
        return self

    def report(self, work, *, args=None, draws=(), outputs=()) -> None:
        """The call's declared work (``kernels.work.Work``), its
        arguments, its noise draws and the tensors it returns."""
        if self.rec._kernel_depth != 1:      # a call inside another call
            return
        self.record = KernelRecord(self.name, work, dict(args or {}),
                                   list(draws))
        for t in op_cost._tensors(list(outputs)):
            self.rec._track_tensor(t)

    def __exit__(self, exc_type, *exc):
        self.rec._kernel_depth -= 1
        if exc_type is None and self.record is not None:
            self.rec._add_kernel(self.record)
        return False


def kernel_call(name: str):
    """The context a kernel wrapper runs its call in: ``with
    kernel_call("dp_mix_round") as call: ...; if call: call.report(work,
    ...)``. Without an open recorder, a false no-op."""
    rec = active()
    return _NULL if rec is None else _KernelCall(rec, name)


class _Uncounted:
    def __init__(self, rec: "Recorder"):
        self.rec = rec

    def __enter__(self):
        self.rec._kernel_depth += 1
        return self

    def __exit__(self, *exc):
        self.rec._kernel_depth -= 1
        return False


def uncounted():
    """A block whose aten ops no open recorder counts: a CPU computation
    whose count the caller gives in another form."""
    rec = active()
    return _NULL if rec is None else _Uncounted(rec)


def note_draw(draw: Draw) -> None:
    """A plain counter-hash draw (``kernels.noise``) outside any kernel
    call: recorded as a call of its own, "noise"."""
    rec = active()
    if rec is not None and rec._kernel_depth == 0:
        rec._add_kernel(KernelRecord("noise", None, {}, [draw]))


# ---- pointwise shape inference on the meta device --------------------------

_a = torch.ops.aten
_BINARY = {_a.add.Tensor, _a.sub.Tensor, _a.mul.Tensor, _a.div.Tensor,
           _a.maximum.default, _a.minimum.default, _a.pow.Tensor_Tensor,
           _a.pow.Tensor_Scalar, _a.add.Scalar, _a.sub.Scalar,
           _a.mul.Scalar, _a.div.Scalar, _a.rsub.Scalar, _a.rsub.Tensor,
           _a.sigmoid_backward.default, _a.tanh_backward.default,
           _a.silu_backward.default, _a.threshold_backward.default,
           _a.gelu_backward.default, _a.clamp.default, _a.clamp_min.default,
           _a.clamp_max.default, _a.where.self}
_COMPARE = {_a.eq.Tensor, _a.ne.Tensor, _a.lt.Tensor, _a.le.Tensor,
            _a.gt.Tensor, _a.ge.Tensor, _a.eq.Scalar, _a.ne.Scalar,
            _a.lt.Scalar, _a.le.Scalar, _a.gt.Scalar, _a.ge.Scalar,
            _a.logical_and.default, _a.logical_or.default,
            _a.logical_not.default}
_UNARY = {_a.neg.default, _a.exp.default, _a.log.default, _a.sqrt.default,
          _a.rsqrt.default, _a.abs.default, _a.sigmoid.default,
          _a.tanh.default, _a.silu.default, _a.gelu.default,
          _a.log1p.default, _a.expm1.default, _a.sin.default,
          _a.cos.default, _a.reciprocal.default, _a.erf.default,
          _a.relu.default, _a.square.default}
_INPLACE = {_a.add_.Tensor, _a.sub_.Tensor, _a.mul_.Tensor, _a.div_.Tensor,
            _a.add_.Scalar, _a.mul_.Scalar, _a.div_.Scalar,
            _a.clamp_.default, _a.clamp_min_.default}


def _fast_meta(func, args, kwargs):
    """The output of a pointwise op over contiguous meta tensors, or None
    where the rules here are not the op's own (then the op runs)."""
    if kwargs and not set(kwargs) <= {"alpha", "rounding_mode", "approximate"}:
        return None
    if kwargs.get("rounding_mode") is not None:
        return None
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if not ts or any(t.device.type != "meta" for t in ts):
        return None
    if any(not isinstance(a, (torch.Tensor, int, float, bool)) and a is not None
           for a in args):
        return None
    shape = _broadcast(*(t.shape for t in ts))
    if shape is None:
        return None
    if func in _INPLACE:
        return args[0] if shape == tuple(args[0].shape) else None
    # one tensor operand: the output takes its layout (empty_like's);
    # several: only where all are contiguous, the output then is too
    like = ts[0] if len(ts) == 1 and shape == tuple(ts[0].shape) else None
    if like is None and not all(t.is_contiguous() for t in ts):
        return None
    if func in _COMPARE:
        dtype = torch.bool
    elif func in _UNARY:
        dtype = ts[0].dtype
        if not dtype.is_floating_point:
            return None
    elif func in _BINARY:
        ops = [a for a in args if a is not None]
        if func is _a.where.self:
            ops = ops[1:]
        dtype = ops[0].dtype if len(ops) == 1 else torch.result_type(*ops[:2])
        if func in (_a.div.Tensor, _a.div.Scalar) and not dtype.is_floating_point:
            return None
    else:
        return None
    if like is not None:
        return torch.empty_like(like, dtype=dtype)
    return torch.empty(shape, dtype=dtype, device="meta")


def _broadcast(*shapes):
    """The broadcast of ``shapes``, or None where they do not broadcast."""
    n = max(len(s) for s in shapes)
    out = [1] * n
    for s in shapes:
        for i, d in enumerate(s, n - len(s)):
            d = int(d)
            if d != 1:
                if out[i] not in (1, d):
                    return None
                out[i] = d
    return tuple(out)


_FAST = _BINARY | _COMPARE | _UNARY | _INPLACE


# ---- collectives -----------------------------------------------------------

def _group_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _shapes(*ts):
    return [tuple(t.shape) for t in ts]


def _collective_patches(rec: "Recorder") -> Dict[str, Any]:
    """{name: wrapper} of the torch.distributed functions to patch."""
    import torch.distributed as dist

    def wrap(name, op, tensors):
        orig = getattr(dist, name)

        def patched(*args, **kwargs):
            ins, outs, raw, group = tensors(*args, **kwargs)
            rec._add_collective(CollectiveRecord(
                op, name, _shapes(*ins), _shapes(*outs), raw,
                _group_size(group)))
            return orig(*args, **kwargs)

        patched.__wrapped__ = orig
        return patched

    def grp(kwargs, args, i):
        return kwargs.get("group", args[i] if len(args) > i else None)

    def all_reduce(tensor, *args, **kw):
        return [tensor], [tensor], op_cost.nbytes(tensor), grp(kw, args, 1)

    def broadcast(tensor, *args, **kw):
        return [tensor], [tensor], op_cost.nbytes(tensor), grp(kw, args, 1)

    def gather(out, inp, *args, **kw):          # bytes: the gathered output
        return [inp], [out], op_cost.nbytes(out), grp(kw, args, 0)

    def scatter(out, inp, *args, **kw):         # bytes: the full input
        return [inp], [out], op_cost.nbytes(inp), grp(kw, args, 1)

    def all_to_all(out, inp, *args, **kw):
        return [inp], [out], op_cost.nbytes(inp), grp(kw, args, 2)

    def p2p(ops, *args, **kw):
        ts = [o.tensor for o in ops]
        return ts, ts, sum(op_cost.nbytes(t) for t in ts) // 2, ops[0].group

    table = {"all_reduce": ("all-reduce", all_reduce),
             "broadcast": ("collective-permute", broadcast),
             "all_gather_into_tensor": ("all-gather", gather),
             "all_gather_single": ("all-gather", gather),
             "reduce_scatter_tensor": ("reduce-scatter", scatter),
             "all_to_all_single": ("all-to-all", all_to_all),
             "batch_isend_irecv": ("collective-permute", p2p)}
    return {name: wrap(name, op, fn) for name, (op, fn) in table.items()
            if hasattr(dist, name)}


# ---- the recorder ----------------------------------------------------------

class Recorder(TorchDispatchMode):
    """See the module docstring."""

    def __init__(self, *, keep_ops: bool = True):
        super().__init__()
        self.keep_ops = keep_ops
        self.cost = op_cost.Cost()
        self.ops: List[OpRecord] = []
        self.kernels: List[KernelRecord] = []
        self.collectives: List[CollectiveRecord] = []
        self.streams: List[StreamDraw] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._tracked: Dict[int, int] = {}
        self._index = 0
        self._kernel_depth = 0
        self._patched: Dict[str, Any] = {}

    # -- entry and exit
    def __enter__(self):
        _STACK.append(self)
        try:
            import torch.distributed as dist
            if dist.is_available():
                for name, fn in _collective_patches(self).items():
                    self._patched[name] = getattr(dist, name)
                    setattr(dist, name, fn)
            return super().__enter__()
        except BaseException:
            self._restore()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._restore()

    def _restore(self) -> None:
        if self._patched:
            import torch.distributed as dist
            for name, orig in self._patched.items():
                setattr(dist, name, orig)
            self._patched = {}
        if _STACK and _STACK[-1] is self:
            _STACK.pop()

    # -- memory
    def track(self, tree) -> int:
        """Count the storages of a tree's tensors (a program's arguments)
        as live; returns their bytes."""
        from repro_torch.core.exchange import tree_flatten
        before = self.live_bytes
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._track_tensor(t)
        return self.live_bytes - before

    def _track_tensor(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._tracked.pop(key, 0)

    # -- records
    def _add_kernel(self, record: KernelRecord) -> None:
        record.index = self._index
        self._index += 1
        for d in record.draws:
            d.call = record.index
        self.kernels.append(record)
        if record.work is not None:
            self.cost.add_kernel(record.name, record.work)

    def _add_collective(self, record: CollectiveRecord) -> None:
        record.index = self._index
        self._index += 1
        self.collectives.append(record)
        self.cost.add_collective(record.op, record.raw_bytes,
                                 record.group_size)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._kernel_depth:
            return func(*args, **kwargs)
        gen = kwargs.get("generator")
        start = None
        if self.keep_ops and isinstance(gen, torch.Generator):
            start = (gen.initial_seed(), _state_digest(gen))
        out = None
        if func in _FAST:
            out = _fast_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional"):
            return out                  # counted by the collective patches
        flops, cls = op_cost.op_flops(func, args, kwargs, out)
        nb = op_cost.op_bytes(func, args, kwargs, out)
        self.cost.add_op(flops, cls, nb)
        outs = list(op_cost._tensors(out))
        for t in outs:
            self._track_tensor(t)
        numel = sum(t.numel() for t in outs if t.device.type != "meta")
        if start is not None and numel:
            self.streams.append(StreamDraw(str(func), *start, numel,
                                           self._index))
        if self.keep_ops:
            ins = list(op_cost._tensors(list(args) + list(kwargs.values())))
            self.ops.append(OpRecord(
                str(func), _shapes(*ins), [t.dtype for t in ins],
                [t.device.type for t in ins], _shapes(*outs),
                [t.dtype for t in outs], [t.device.type for t in outs],
                func.is_view, func._schema.is_mutable, flops, cls, nb,
                self._index))
        self._index += 1
        return out

