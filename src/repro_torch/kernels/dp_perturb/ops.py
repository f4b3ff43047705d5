"""Wrappers of the fused local step: ``sgd_update`` (sigma = 0) and
``dp_perturb`` (local step + DP noise + power scale), with the reference's
signatures (repro/kernels/dp_perturb/ops.py), and ``sgd_update_leaves``,
the protocol's local step with ``use_pallas=True``: every leaf of the
model in one launch.

Dispatch is by the device of ``p``: a CUDA tensor launches the
hand-written kernel (``csrc/dp_perturb.cu``) or raises; a CPU tensor runs
the plain version (``dp_perturb.dp_perturb_plain``). There is no fallback
between the two. The kernel takes a table of up to 16 leaves by value:
``sgd_update`` and ``dp_perturb`` launch it with one entry,
``sgd_update_leaves`` with all the leaves (16 at a time).
``sgd_update.launches``, ``dp_perturb.launches`` and
``sgd_update_leaves.launches`` count the kernel launches of each wrapper.

Dtype contract (the reference's): outputs carry p's dtype (float32 or
bfloat16 on the card); the arithmetic is float32. The kernel reads its
operands as flat contiguous arrays, so the wrapper makes p and g
contiguous first: an ``expand``ed view passed by its pointer would make
every worker read worker 0's memory. Noisy leaves are limited to 2^31
elements: past that the uint32 noise counters wrap and two elements would
draw the same noise.
"""
from __future__ import annotations

import array
import ctypes
import functools
import types
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_perturb.dp_perturb import dp_perturb_plain

COUNTER_LIMIT = 1 << 31
MAX_LEAVES = 16                          # entries of the kernel's leaf table

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = build.Library("dp_perturb", sources=(_CSRC / "dp_perturb.cu",),
                        headers=build.SHARED_HEADERS)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_X_ONLY, _SCALED, _NOISY = 0, 1, 2      # the kernel's modes


def _library() -> ctypes.CDLL:
    lib = build.load(LIBRARY)
    fn = lib.dp_perturb_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr, ptr, ptr,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.dp_perturb_error_string.argtypes = [ctypes.c_int]
        lib.dp_perturb_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _plan(pspecs, gspecs):
    """What a launch over one layout of leaves needs besides their
    pointers, worked out once per layout: the checks, the element counts
    and the output views. A spec is a leaf's (shape, dtype, device,
    contiguous). The leaves must share one float dtype and device, each g
    shaped like its p. The outputs are one allocation of ``total``
    elements, each leaf's view (shape, stride, offset) starting on a
    16-byte boundary so that the kernel's vector path holds for every
    leaf; ``x_bytes`` are those starts in bytes."""
    (_, dtype, device, _) = pspecs[0]
    if dtype not in _DTYPES:
        raise TypeError(f"dp_perturb kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    for (shape, pdt, pdev, _), (gshape, gdt, gdev, _) in zip(pspecs, gspecs):
        if pdt != dtype or pdev != device:
            raise ValueError(f"dp_perturb: one launch takes leaves of one "
                             f"dtype and device, got {pdt} on {pdev} "
                             f"beside {dtype} on {device}")
        if gshape != shape or gdt != dtype or gdev != device:
            raise ValueError(f"dp_perturb operand g: want {tuple(shape)} "
                             f"{dtype} on {device}, got {tuple(gshape)} "
                             f"{gdt} on {gdev}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    align = 16 // itemsize
    views, total = [], 0
    for shape, *_ in pspecs:
        views.append((shape, torch.empty(shape, device="meta").stride(), total))
        total += -(-shape.numel() // align) * align
    return types.SimpleNamespace(
        dtype=dtype, device=device, code=_DTYPES[dtype], count=len(pspecs),
        copy=not all(s[3] for s in pspecs + gspecs), total=total, views=views,
        x_bytes=[o * itemsize for _, _, o in views],
        ns=array.array("q", [shape.numel() for shape, *_ in pspecs]))


def _launch(ps, gs, seed, mode: int, *, gamma: float, s_sig: float = 1.0,
            noise_scale: float = 0.0):
    """One launch over up to MAX_LEAVES leaves of one dtype; returns (xs,
    xts or None), each a list of views into one allocation. The wrapper's
    host time is most of a round's, so all that depends only on the
    leaves' layout comes from ``_plan``'s cache."""
    plan = _plan(
        tuple([(p.shape, p.dtype, p.device, p.is_contiguous()) for p in ps]),
        tuple([(g.shape, g.dtype, g.device, g.is_contiguous()) for g in gs]))
    if plan.copy:
        ps = [p.contiguous() for p in ps]
        gs = [g.contiguous() for g in gs]
    outs = []
    for _ in range(1 if mode == _X_ONLY else 2):
        buf = torch.empty(plan.total, dtype=plan.dtype, device=plan.device)
        base = buf.data_ptr()
        outs.append(([buf.as_strided(*v) for v in plan.views],
                     [base + o for o in plan.x_bytes]))
    xs, xts = outs[0][0], (None if mode == _X_ONLY else outs[1][0])
    # the host arrays the C entry reads: plain buffers, cheaper to fill
    # than ctypes arrays
    ptrs = array.array("Q", [p.data_ptr() for p in ps]
                       + [g.data_ptr() for g in gs] + outs[0][1] + outs[-1][1])
    lib = _library()
    rc = lib.dp_perturb_launch(
        plan.code, mode, plan.count, ptrs.buffer_info()[0],
        plan.ns.buffer_info()[0], None if seed is None else seed.data_ptr(),
        gamma, s_sig, noise_scale,
        torch._C._cuda_getCurrentRawStream(plan.device.index))
    if rc != 0:
        raise RuntimeError(f"dp_perturb kernel launch failed: "
                           f"{lib.dp_perturb_error_string(rc).decode()} ({rc})")
    return xs, xts


def sgd_update_plain(p, g, gamma: float):
    """p - gamma g in p's dtype (the reference's x), in plain PyTorch."""
    return dp_perturb_plain(p, g, 0, gamma=gamma, sigma=0.0, s_sig=1.0,
                            s_noise=0.0)[0]


def sgd_update(p, g, gamma: float):
    """Fused SGD step (the sigma = 0 path): p - gamma g in p's dtype."""
    if p.device.type == "cuda":
        (x,), _ = _launch([p], [g], None, _X_ONLY, gamma=float(gamma))
        sgd_update.launches += 1
        return x
    if p.device.type == "cpu":
        return sgd_update_plain(p, g, gamma)
    raise ValueError(f"sgd_update has no path for device {p.device}")


sgd_update.launches = 0


def sgd_update_leaves_plain(ps, gs, gamma: float):
    """The per-leaf plain version mapped over the leaves."""
    return [sgd_update_plain(p, g, gamma) for p, g in zip(ps, gs)]


def sgd_update_leaves(ps, gs, gamma: float):
    """``sgd_update`` of every leaf: [p - gamma g for each (p, g)], each in
    its p's dtype. On the card one launch for up to MAX_LEAVES leaves of
    one dtype (a longer list takes one launch per MAX_LEAVES), the outputs
    contiguous views into one allocation; bitwise the per-leaf kernel."""
    ps, gs = list(ps), list(gs)
    if len(ps) != len(gs):
        raise ValueError(f"sgd_update_leaves: {len(ps)} parameter leaves, "
                         f"{len(gs)} gradient leaves")
    if not ps:
        return []
    if ps[0].device.type == "cuda":
        xs = []
        for i in range(0, len(ps), MAX_LEAVES):
            chunk, _ = _launch(ps[i:i + MAX_LEAVES], gs[i:i + MAX_LEAVES],
                               None, _X_ONLY, gamma=float(gamma))
            sgd_update_leaves.launches += 1
            xs += chunk
        return xs
    if ps[0].device.type == "cpu":
        return sgd_update_leaves_plain(ps, gs, gamma)
    raise ValueError(f"sgd_update_leaves has no path for device "
                     f"{ps[0].device}")


sgd_update_leaves.launches = 0


def dp_perturb(p, g, seed, *, gamma: float, sigma: float, s_sig: float,
               s_noise: float):
    """Fused local step + DP noise + power scale. seed: int32 scalar (an
    int or a tensor). Returns (x_new, x_tilde) with x_tilde = s_sig (p -
    gamma g) + s_noise sigma G, G the counter-hash Box-Muller normal."""
    noisy = sigma > 0.0 and s_noise != 0.0
    if noisy and p.numel() > COUNTER_LIMIT:
        raise ValueError(f"a noisy leaf of {p.numel()} elements exceeds 2^31: "
                         f"the uint32 noise counters would wrap and reuse "
                         f"noise")
    if p.device.type == "cuda":
        if isinstance(seed, int):      # a fill on the device, not a copy
            seed = torch.full((1,), seed, dtype=torch.int32, device=p.device)
        seed = torch.as_tensor(seed, dtype=torch.int32,
                               device=p.device).reshape(1)
        scale = float(np.float32(sigma) * np.float32(s_noise))
        (x,), (xt,) = _launch([p], [g], seed, _NOISY if noisy else _SCALED,
                              gamma=float(gamma), s_sig=float(s_sig),
                              noise_scale=scale)
        dp_perturb.launches += 1
        return x, xt
    if p.device.type == "cpu":
        return dp_perturb_plain(p, g, seed, gamma=gamma, sigma=sigma,
                                s_sig=s_sig, s_noise=s_noise)
    raise ValueError(f"dp_perturb has no path for device {p.device}")


dp_perturb.launches = 0
