"""Counter-hash noise streams in plain PyTorch — the port of the reference's
interpret-mode generators (``repro.kernels.dp_perturb.dp_perturb._hash_bits``
and ``repro.kernels.dp_mix.dp_mix._normal_from_bits`` /
``_normal_pair_hash``). Two streams share the hash: dp_mix's inverse-CDF
normals (this docstring) and dp_perturb's Box-Muller normals
(``perturb_normals``, below).

Element (r, c) of a column window starting at global column ``col0`` draws
its two standard normals from the uint32 counters

    idx = (row0 + r) * counter_width + col0 + c        (mod 2^32)
    g1  = normal(hash(2 * idx,     seed))
    g2  = normal(hash(2 * idx + 1, seed))

uint32 arithmetic is done in int64 with ``& 0xFFFFFFFF``; products are
split into 16-bit halves so no int64 product overflows. The bits are
bitwise those of the reference.

Normals come from the inverse CDF on a symmetric 24-bit lattice,
sqrt(2) * erfinv(t). ``torch.erfinv`` differs from the reference by up to
91 ULP, so erfinv is written out as the float32 operation sequence the
reference's XLA CPU lowering executes: Giles' single-precision polynomial
on w = -log1p(-t^2), with log1p itself in XLA's Cephes form. The steps
that compiler contracts into fused multiply-adds are fused here too
(``_fma``: one rounding, through float64), all others round after every
operation. Over all 2^24 lattice points this is bitwise the reference
except 274 tail points (|t| > 0.9966), where XLA's CPU square root is an
estimate and the two differ by at most 2 ULP. ``csrc/noise.cuh`` is the
same sequence for the CUDA kernels.

dp_perturb's stream (``perturb_normals``) draws element e of a flattened
leaf from the uint32 counters

    ctr1 = e + 32768 * (e >> 15) + seed * 0x9E3779B9     (mod 2^32)
    ctr2 = ctr1 + 32768

which is the reference's ``base + idx`` / ``base + idx + n`` with base =
pid * 2n + seed * 0x9E3779B9 over its [256, 128] tiles (n = 32768, pid =
e // n): the counters depend on e only, not on any tiling. The uniforms
are (bits >> 8) * 2^-24 + 1e-7 and the normal is Box-Muller,
sqrt(-2 log u1) * cos(f32(2 pi) * u2), rounded after every operation.
``torch.log``/``torch.cos`` are not XLA's, so these normals differ from
the reference's by a few ULP (tests/test_torch_dp_perturb.py states the
bound); the bits and uniforms are bitwise.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M1, _M2, _M3 = 2654435761, 2246822519, 3266489917
GOLDEN = 0x9E3779B9
PERTURB_TILE = 256 * 128    # elements of one reference tile (n above)
TWO_PI_F32 = float(np.float32(2.0 * math.pi))   # folded in f64, rounded once

IntLike = Union[int, torch.Tensor]


def _f(bits: int) -> float:
    """The float32 with these bits, as a Python float (exact)."""
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# Giles (2010) single-precision erfinv coefficients, highest order first,
# for w = -log1p(-t^2) < 5 (central) and >= 5 (tail).
_GILES_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_GILES_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

# XLA CPU log1p: Cephes log (|x| >= sqrt(2) - 1) and Cephes log1p rational
# (|x| < sqrt(2) - 1), float32 bit patterns.
_LOG_P = [_f(b) for b in (0x3d9021bb, 0xbdebd1b8, 0x3def251a,    # a-chain
                          0xbdfe5d4f, 0x3e11e9bf, 0xbe2aae50,    # b-chain
                          0x3e4cceac, 0xbe7ffffc, 0x3eaaaaaa)]   # c-chain
_LOG_Q1, _LOG_Q2 = _f(0xb95e8083), 0.693359375
_SQRTHF = _f(0x3f3504f3)
_MIN_NORMAL = _f(0x00800000)
_L1P_DEN = [_f(b) for b in (0x417101ad, 0x42a6185b, 0x435dc32d, 0x439a8ca3,
                            0x43586d8a, 0x42707982)]
_L1P_NUM0 = _f(0x383de04b)
_L1P_NUM = [_f(b) for b in (0x3eff40c5, 0x40d284fa, 0x41ef4b9c, 0x4273cc76,
                            0x426473ad, 0x41a05101)]
_L1P_SMALL = _f(0x3ed413cd)


def _u32(v: IntLike, device) -> torch.Tensor:
    """An int or int tensor reinterpreted as uint32, held in int64."""
    return torch.as_tensor(v, dtype=torch.int64, device=device) & MASK32


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & MASK32


def hash_bits(idx: torch.Tensor, seed: IntLike) -> torch.Tensor:
    """uint32 counters -> uint32 hash bits (as int64): the reference's
    xorshift-multiply mix, bit for bit."""
    x = _mul32(idx.to(torch.int64) & MASK32, _M1) ^ _u32(seed, idx.device)
    x = x ^ (x >> 16)
    x = _mul32(x, _M2)
    x = x ^ (x >> 13)
    x = _mul32(x, _M3)
    return x ^ (x >> 16)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: a*b is exact in float64, so the sum is
    rounded once (to float64, then float32 — equal to fmaf except on
    double-rounding ties)."""
    return (a.double() * b + (c.double() if torch.is_tensor(c) else c)
            ).float()


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p(x), x > -1, as XLA's CPU backend computes it."""
    # Cephes log on y = 1 + x: y = m * 2^e with m in [sqrt(1/2), sqrt(2))
    y = torch.clamp_min(x + 1.0, _MIN_NORMAL)
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRTHF
    e = e - low.to(torch.float32)
    u = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    u2 = u * u
    u3 = u2 * u
    a = _fma(_fma(u, _LOG_P[0], _LOG_P[1]), u, _LOG_P[2])
    b = _fma(_fma(u, _LOG_P[3], _LOG_P[4]), u, _LOG_P[5])
    c = _fma(_fma(u, _LOG_P[6], _LOG_P[7]), u, _LOG_P[8])
    a = _fma(_fma(a, u3, b), u3, c)
    a = _fma(a, u3, e * _LOG_Q1)
    large = ((u - u2 * 0.5) + a) + e * _LOG_Q2
    # Cephes log1p rational for small |x|
    den = x + _L1P_DEN[0]
    for coef in _L1P_DEN[1:]:
        den = _fma(den, x, coef)
    num = torch.full_like(x, _L1P_NUM0)
    for coef in _L1P_NUM:
        num = _fma(num, x, coef)
    xx = x * x
    small = x + (xx * -0.5 + (x * xx) * (num / den))
    return torch.where(x.abs() < _L1P_SMALL, small, large)


def erfinv_giles(t: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by Giles' polynomial, |t| < 1."""
    w = -log1p_xla(t * -t)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(central, _GILES_CENTRAL[0], _GILES_TAIL[0]).float()
    for a, b in zip(_GILES_CENTRAL[1:], _GILES_TAIL[1:]):
        p = _fma(p, w, torch.where(central, a, b).float())
    return p * t


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 standard normal. The 24-bit count k maps to
    t = (k - (2^23 - 1/2)) / 2^23, exact in float32 with |t| < 1."""
    t = (((bits >> 8).to(torch.float32) - (float(1 << 23) - 0.5))
         * (1.0 / (1 << 23)))
    return erfinv_giles(t) * torch.tensor(math.sqrt(2.0), dtype=torch.float32,
                                          device=bits.device)


def counters(shape: Tuple[int, int], counter_width: int, col0: IntLike = 0,
             row0: IntLike = 0, device=None) -> torch.Tensor:
    """uint32 element counters idx of an [R, C] window (as int64)."""
    R, C = shape
    rows = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(C, dtype=torch.int64, device=device)[None, :]
    return (_mul32((_u32(row0, device) + rows) & MASK32, counter_width)
            + _u32(col0, device) + cols) & MASK32


def normal_field(shape: Tuple[int, int], counter_width: int, col0: IntLike,
                 seed: IntLike, field: int, row0: IntLike = 0,
                 device=None) -> torch.Tensor:
    """One of the two float32 standard-normal fields over an [R, C]
    window: field 0 from counters 2*idx, field 1 from 2*idx + 1."""
    idx2 = (counters(shape, counter_width, col0, row0, device) * 2) & MASK32
    return normal_from_bits(hash_bits(idx2 + field, seed))


def normal_pair_hash(shape: Tuple[int, int], counter_width: int,
                     col0: IntLike, seed: IntLike, row0: IntLike = 0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent float32 standard-normal fields over an [R, C]
    window, drawn from counters 2*idx and 2*idx + 1."""
    return tuple(normal_field(shape, counter_width, col0, seed, f, row0,
                              device) for f in (0, 1))


def perturb_counters(n_elems: int, seed: IntLike, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dp_perturb's two uint32 counters (as int64) of elements 0..n-1."""
    e = torch.arange(n_elems, dtype=torch.int64, device=device)
    ctr1 = (e + PERTURB_TILE * (e >> 15)
            + _mul32(_u32(seed, device), GOLDEN)) & MASK32
    return ctr1, (ctr1 + PERTURB_TILE) & MASK32


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniform in (0, 1]: (bits >> 8) 2^-24 + 1e-7."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-7


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """sqrt(-2 log u1) cos(2 pi u2) in float32, one rounding per step."""
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI_F32 * u2)


def perturb_normals(n_elems: int, seed: IntLike, device=None) -> torch.Tensor:
    """dp_perturb's [n_elems] float32 standard normals at ``seed``."""
    ctr1, ctr2 = perturb_counters(n_elems, seed, device)
    return box_muller(uniform_from_bits(hash_bits(ctr1, seed)),
                      uniform_from_bits(hash_bits(ctr2, seed)))
