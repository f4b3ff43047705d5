"""Wrapper of the SSD intra-chunk kernel and the full chunked scan, with the
reference's signature and arithmetic (repro/kernels/ssd_scan/ops.py).

``ssd_intra_chunk(x, dt, dA, Bm, Cm, *, chunk)``: x [B, S, H, P], dt and dA
[B, S, H], Bm and Cm [B, S, N] -> (y_diag [B, S, H, P] in x's dtype, states
[B, nc, H, P, N] float32, cdecay [B, nc, H] float32). Dispatch is by the
device of x: a CUDA tensor launches the hand-written kernel
(``csrc/ssd_scan.cu``) or raises; a CPU tensor runs the plain version
(``ssd_scan.ssd_intra_chunk_plain``). There is no fallback between the
two. ``ssd_intra_chunk.launches`` counts the kernel's launches.

``ssd_scan(xh, dt, A, Bm, Cm, *, chunk, initial_state=None)``: the
reference's full scan, (y [B, S, H, P], final_state [B, H, P, N] float32):
chunk = min(chunk, S), dA = dt A in float32, the intra-chunk step above,
then the inter-chunk state recurrence (a loop over the chunks) and the
off-diagonal term in torch (``ssd_scan.inter_chunk``), as the reference
leaves both outside its kernel.

Contract, on either device (``ValueError`` outside it): x, Bm, Cm float32
or bfloat16, of one dtype and device; S a multiple of the chunk q; q <=
256; N, P <= 128; H a multiple of min(8, H). x, Bm and Cm are read through
their strides (a view into the model's conv output is not copied; only an
operand whose last axis is not contiguous is); dt and dA go in as
contiguous float32.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ssd_scan import (cumsum_f32, inter_chunk,
                                                   ssd_intra_chunk_plain)

MAX_CHUNK = 256
MAX_DIM = 128   # N and P
HEAD_BLOCK = 8  # heads per block, the reference's HB

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = build.Library("ssd_scan", sources=(_CSRC / "ssd_scan.cu",),
                        headers=build.SHARED_HEADERS)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# ssd_scan_launch's parameters, in order (csrc/ssd_scan.cu)
ARGTYPES = ([_I32] * 7 + [_PTR, _I64, _I64, _I64] + [_PTR, _PTR]
            + [_PTR, _I64, _I64] * 2 + [_PTR] * 5)


def _library() -> ctypes.CDLL:
    lib = build.load(LIBRARY)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, dA, Bm, Cm, chunk: int):
    if x.dim() != 4 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError(f"ssd_scan takes x [B,S,H,P] and Bm, Cm [B,S,N]; got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, S, H) or tuple(dA.shape) != (B, S, H):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} and dA "
                         f"{tuple(dA.shape)} must be [B,S,H] = {(B, S, H)}")
    if Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"ssd_scan: Bm {tuple(Bm.shape)} and Cm "
                         f"{tuple(Cm.shape)} must be [B,S,N] with B, S of x")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} outside [1, {MAX_CHUNK}]")
    if S % chunk:
        raise ValueError(f"ssd_scan: S = {S} is not a multiple of the chunk "
                         f"{chunk}")
    if not (1 <= N <= MAX_DIM and 1 <= P <= MAX_DIM):
        raise ValueError(f"ssd_scan: N = {N} and P = {P} must be in "
                         f"[1, {MAX_DIM}]")
    if H % min(HEAD_BLOCK, H):
        raise ValueError(f"ssd_scan: H = {H} is not a multiple of "
                         f"min({HEAD_BLOCK}, H)")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan takes float32 or bfloat16 x, Bm, Cm of one "
                         f"dtype; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if any(t.device != x.device for t in (dt, dA, Bm, Cm)):
        raise ValueError("ssd_scan: inputs on different devices")


def _launch(x, dt, dA, Bm, Cm, *, chunk: int, with_cs: bool = False):
    """One launch of the kernel; returns (y_diag, states, cdecay), and cs
    [B, nc, q, H] float32 after them if ``with_cs``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, Cm))
    dt, dA = (t.float().contiguous() for t in (dt, dA))
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    st = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
    cd = torch.empty((B, nc, H), dtype=torch.float32, device=x.device)
    cs = (torch.empty((B, nc, chunk, H), dtype=torch.float32, device=x.device)
          if with_cs else None)
    lib = _library()
    rc = lib.ssd_scan_launch(
        _DTYPES[x.dtype], B, S, H, P, N, chunk,
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
        dt.data_ptr(), dA.data_ptr(),
        Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
        Cm.data_ptr(), Cm.stride(0), Cm.stride(1),
        y.data_ptr(), st.data_ptr(), cd.data_ptr(),
        cs.data_ptr() if with_cs else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(rc).decode()} ({rc})")
    ssd_intra_chunk.launches += 1
    return (y, st, cd, cs) if with_cs else (y, st, cd)


def ssd_intra_chunk(x, dt, dA, Bm, Cm, *, chunk: int):
    """The intra-chunk step: (y_diag, states, cdecay), see the module."""
    _check(x, dt, dA, Bm, Cm, chunk)
    if x.device.type == "cuda":
        return _launch(x, dt, dA, Bm, Cm, chunk=chunk)
    if x.device.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, dA, Bm, Cm, chunk=chunk)
    raise ValueError(f"ssd_scan has no path for device {x.device}")


ssd_intra_chunk.launches = 0


def ssd_scan(xh, dt, A, Bm, Cm, *, chunk: int, initial_state=None):
    """xh: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative);
    Bm, Cm: [B,S,N]. Returns (y [B,S,H,P] in xh's dtype, final_state
    [B,H,P,N] float32)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    dA = dt.float() * A.float()[None, None, :]
    nc = S // chunk
    if xh.device.type == "cuda":
        # the kernel's cs: the within-chunk cumsum in the reference's order,
        # which cumsum_f32 would take again in ~35 small launches
        _check(xh, dt, dA, Bm, Cm, chunk)
        y_diag, states, cdecay, dA_cs = _launch(xh, dt, dA, Bm, Cm, chunk=chunk,
                                                with_cs=True)
    else:
        y_diag, states, cdecay = ssd_intra_chunk(xh, dt, dA, Bm, Cm, chunk=chunk)
        dA_cs = cumsum_f32(dA.reshape(B, nc, chunk, H), dim=2)
    Cc = Cm.float().reshape(B, nc, chunk, N)
    y_off, h = inter_chunk(states, cdecay, dA_cs, Cc, initial_state)
    y = y_diag + y_off.reshape(B, S, H, P).to(y_diag.dtype)
    return y, h
