"""Wrapper of the flash-attention kernel in the model's layout, with the
reference's signature (repro/kernels/flash_attention/ops.py).

``flash_attention(q, k, v, *, causal=True, sliding_window=None)``: q [B, S,
H, hd], k and v [B, S, Hkv, hd] -> o [B, S, H, hd]. Dispatch is by the
device of q: a CUDA tensor launches the hand-written kernel
(``csrc/flash_attention.cu``, both instantiations on the tensor cores:
float32 as split TF32 mma.sync, ``csrc/flash_f32_sm90.cuh``; bfloat16 as
wgmma, ``csrc/flash_bf16_sm90.cuh``) or raises; a CPU tensor runs
the plain version (``flash_attention.flash_attention_plain``). There is no
fallback between the two. ``flash_attention.launches`` counts the
kernel's launches.

Contract, on either device: float32 or bfloat16, q, k, v of one dtype and
device; hd in {32, 64, 128, 256}; H a multiple of Hkv (query head h reads
KV head h // (H // Hkv)); ``sliding_window`` None or positive. The kernel
reads its operands through their strides, so no GQA repeat and no
transpose is made; only an operand whose head_dim axis is not contiguous,
or that is not 16-byte aligned or has a stride that is not a multiple of
16 bytes, is copied first (TMA and cp.async read 16 bytes at a time). The
output is in the input's dtype.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_plain

HEAD_DIMS = (32, 64, 128, 256)

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = build.Library("flash_attention", sources=(_CSRC / "flash_attention.cu",),
                        headers=build.SHARED_HEADERS + (_CSRC / "flash_bf16_sm90.cuh",
                                                        _CSRC / "flash_f32_sm90.cuh"))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# flash_attention_launch's parameters, in order (csrc/flash_attention.cu)
ARGTYPES = ([_I32] * 6 + [_PTR, _I64, _I64, _I64] * 4
            + [_I32, _I32, ctypes.c_float, _PTR])


def _library() -> ctypes.CDLL:
    lib = build.load(LIBRARY)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, sliding_window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes q [B,S,H,hd] and k, v "
                         f"[B,S,Hkv,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if H % Hkv != 0:
        raise ValueError(f"flash_attention: H = {H} query heads is not a "
                         f"multiple of Hkv = {Hkv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")


def _readable(t) -> bool:
    """Can the kernel read ``t`` as it is? The head_dim axis contiguous,
    the base 16-byte aligned and the other strides multiples of 16 bytes
    (a TMA tensor map in bfloat16, 16-byte cp.async in float32)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3]))


def _launch(q, k, v, *, causal: bool, sliding_window: Optional[int]):
    """One launch of the kernel; returns o [B, S, H, hd]."""
    B, S, H, hd = q.shape
    q, k, v = (t if _readable(t) else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib = _library()
    args = []
    for t in (q, k, v, o):
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    rc = lib.flash_attention_launch(
        _DTYPES[q.dtype], hd, B, S, H, k.shape[2], *args, int(bool(causal)),
        int(sliding_window or 0), float(np.float32(1.0 / math.sqrt(hd))),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()} ({rc})")
    return o


def flash_attention(q, k, v, *, causal: bool = True,
                    sliding_window: Optional[int] = None):
    """q: [B,S,H,hd]; k, v: [B,S,Hkv,hd] -> [B,S,H,hd] in q's dtype."""
    _check(q, k, v, sliding_window)
    if q.device.type == "cuda":
        o = _launch(q, k, v, causal=causal, sliding_window=sliding_window)
        flash_attention.launches += 1
        return o
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=sliding_window)
    raise ValueError(f"flash_attention has no path for device {q.device}")


flash_attention.launches = 0
