"""Wrappers of the fused DWFL round: ``dp_mix_round`` over the flat [N, d]
buffer with a dense W, ``dp_mix_round_sparse`` with a padded neighbor list
(``net.sparse.SparseW``), ``dp_mix_round_plan`` over a ``MixPlan`` (either
W), and ``seed_from_key``.

Dispatch is by the device of the buffer: a CUDA tensor launches the
hand-written kernel (``csrc/dp_mix.cu``) or raises; a CPU tensor runs the
plain version (``dp_mix.dp_mix_plain``). There is no fallback between the
two. ``dp_mix_round.launches`` counts the kernel launches.

A stack of R rounds (the fleet: p, g [R, N, d], W [R, N, N], the
per-receiver vectors [R, N], c, sigma_m and seed [R]) is one call and one
launch: the replicate is a grid axis of the kernel, each replicate's
noise counters start at 0 under its own seed, and replicate r is bitwise
``dp_mix_round`` on replicate r's operands. Its plain version is
``dp_mix.dp_mix_plain_stack``, ``dp_mix_plain`` applied to each replicate.

Dtype contract (the reference's): the output has the input buffer's dtype
(float32 or bfloat16 on the card); the arithmetic is float32.

The kernel takes any N. Its C launch picks one of two routes from N and
the card's shared memory: one kernel while the column route's blocks fit
(N up to a few tens); beyond, two (``dp_mix_prep`` writes z and the DP
noise to a float32 workspace [2, N, d], which ``_launch`` allocates when
the library asks for one, and ``dp_mix_tiled`` mixes it). Either way a
round is one call and one count.

Checked here before any launch, on every device: N * counter_width <=
2^31. The noise counters 2 * idx are uint32, and past that they wrap and
two elements would draw the same noise (at dwfl-paper's width, N <= 2,511).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_mix.dp_mix import (dp_mix_plain, dp_mix_plain_stack,
                                              dp_mix_sparse_plain)

LANES = 128            # noise-counter row stride multiple (the reference's)
SUBLANES = 8           # the sparse round's worker-axis pad (the reference's)
COUNTER_LIMIT = 1 << 31

_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = build.Library("dp_mix", sources=(_CSRC / "dp_mix.cu",),
                        headers=build.SHARED_HEADERS)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR = ctypes.c_void_p
# dp_mix_launch's parameters, in order
ARGTYPES = ([ctypes.c_int] + [_PTR] * 12 + [ctypes.c_int] * 3
            + [ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_int,
               _PTR])
# dp_mix_sparse_launch's parameters, in order
SPARSE_ARGTYPES = ([ctypes.c_int] + [_PTR] * 14 + [ctypes.c_int] * 3
                   + [ctypes.c_uint, ctypes.c_float, ctypes.c_float,
                      ctypes.c_int, _PTR])


def _roundup(n: int, m: int) -> int:
    return -(-n // m) * m


def seed_from_key(key) -> torch.Tensor:
    """A PRNG key's raw words (the reference's ``jax.random.key_data``, as
    numpy or a tensor) -> the int32 kernel seed: its last word."""
    words = np.asarray(key.cpu() if torch.is_tensor(key) else key)
    return torch.tensor(words.reshape(-1)[-1].astype(np.uint32).view(np.int32))


def _on(v, shape, dtype, device) -> torch.Tensor:
    """A tensor or a Python number as a ``dtype`` tensor of ``shape`` on
    ``device``. Numbers become a fill on the device, never a host-to-device
    copy, which would wait for the stream."""
    if isinstance(v, (int, float)):
        return torch.full(shape, v, dtype=dtype, device=device)
    v = torch.as_tensor(v, dtype=dtype, device=device)
    return (v.expand(shape) if v.ndim == 0 else v.reshape(shape)).contiguous()


def _library() -> ctypes.CDLL:
    lib = build.load(LIBRARY)
    fn = lib.dp_mix_launch
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        lib.dp_mix_workspace_floats.argtypes = [ctypes.c_int] * 2
        lib.dp_mix_workspace_floats.restype = ctypes.c_size_t
        lib.dp_mix_error_string.argtypes = [ctypes.c_int]
        lib.dp_mix_error_string.restype = ctypes.c_char_p
        lib.dp_mix_sparse_launch.argtypes = SPARSE_ARGTYPES
        lib.dp_mix_sparse_launch.restype = ctypes.c_int
    return lib


def _check(p, operands) -> None:
    """Each (name, tensor, shape, dtype) of ``operands`` is contiguous, of
    that shape and dtype, on p's device; p is float32 or bfloat16."""
    if p.dtype not in _DTYPES:
        raise TypeError(f"dp_mix kernel takes float32 or bfloat16, got "
                        f"{p.dtype}")
    for name, a, shape, dtype in operands:
        if (tuple(a.shape) != shape or a.dtype != dtype
                or a.device != p.device or not a.is_contiguous()):
            raise ValueError(
                f"dp_mix operand {name}: want contiguous {shape} {dtype} on "
                f"{p.device}, got {tuple(a.shape)} {a.dtype} on {a.device}")


def _vectors(p, g, seed, col0, scal, amp, selfs, mscale, listen):
    """The operands every round shares, as ``_check`` takes them (with
    the leading replicate axis of a stack of rounds)."""
    *lead, N, d = p.shape
    lead = tuple(lead)
    f32, i32 = torch.float32, torch.int32
    return (("g", g, lead + (N, d), p.dtype), ("amp", amp, lead + (N,), f32),
            ("self", selfs, lead + (N,), f32),
            ("m_scale", mscale, lead + (N,), f32),
            ("listen", listen, lead + (N,), f32),
            ("scal", scal, lead + (2,), f32),
            ("seed", seed, lead or (1,), i32), ("col0", col0, (1,), i32))


def _raise_on(lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"dp_mix kernel launch failed: "
                           f"{lib.dp_mix_error_string(rc).decode()} ({rc})")


def _launch(p, g, seed, col0, scal, amp, selfs, mscale, listen, W, *,
            gamma, eta, noisy, counter_width) -> torch.Tensor:
    """One launch over [N, d], or over a stack [R, N, d] of R rounds."""
    *lead, N, d = p.shape
    R = lead[0] if lead else 1
    _check(p, _vectors(p, g, seed, col0, scal, amp, selfs, mscale, listen)
           + (("W", W, tuple(lead) + (N, N), torch.float32),))
    p, g = p.contiguous(), g.contiguous()
    out = torch.empty_like(p)
    lib = _library()
    ws_floats = R * lib.dp_mix_workspace_floats(N, d)
    ws = (torch.empty(ws_floats, dtype=torch.float32, device=p.device)
          if ws_floats else None)
    rc = lib.dp_mix_launch(
        _DTYPES[p.dtype], p.data_ptr(), g.data_ptr(), out.data_ptr(),
        W.data_ptr(), amp.data_ptr(), selfs.data_ptr(), mscale.data_ptr(),
        listen.data_ptr(), scal.data_ptr(), seed.data_ptr(), col0.data_ptr(),
        None if ws is None else ws.data_ptr(),
        R, N, d, counter_width, gamma, eta, int(noisy),
        torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, rc)
    dp_mix_round.launches += 1
    return out


def _launch_sparse(p, g, seed, col0, scal, amp, selfs, mscale, listen, idx,
                   w, self_w, *, gamma, eta, noisy, counter_width
                   ) -> torch.Tensor:
    """dp_mix_prep then dp_mix_gather over the float32 workspace [2, N, d]
    (z, then the DP noise n/c)."""
    N, d = p.shape
    k = idx.shape[1] if idx.ndim == 2 else -1
    _check(p, _vectors(p, g, seed, col0, scal, amp, selfs, mscale, listen)
           + (("idx", idx, (N, k), torch.int32),
              ("w", w, (N, k), torch.float32),
              ("self_w", self_w, (N,), torch.float32)))
    p, g = p.contiguous(), g.contiguous()
    out = torch.empty_like(p)
    ws = torch.empty(2 * N * d, dtype=torch.float32, device=p.device)
    lib = _library()
    rc = lib.dp_mix_sparse_launch(
        _DTYPES[p.dtype], p.data_ptr(), g.data_ptr(), out.data_ptr(),
        idx.data_ptr(), w.data_ptr(), self_w.data_ptr(), amp.data_ptr(),
        selfs.data_ptr(), mscale.data_ptr(), listen.data_ptr(),
        scal.data_ptr(), seed.data_ptr(), col0.data_ptr(), ws.data_ptr(),
        N, d, k, counter_width, gamma, eta, int(noisy),
        torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, rc)
    dp_mix_round_sparse.launches += 1
    return out


def dp_mix_round(p, g, seed, W, amp, c, sigma_m, *, gamma: float, eta: float,
                 self_scale=None, m_scale=None, listen=None,
                 noisy: bool = True, col0=0,
                 counter_width: Optional[int] = None) -> torch.Tensor:
    """One fused DWFL round over the flat buffer.

    p, g: [N, d] params and clipped grads (float dtype, preserved). seed:
    int32 scalar (int or tensor; see ``seed_from_key``). W: [N, N] mixing
    matrix. amp: [N] DP-noise amplitude |h_k| sqrt(beta_k P_k) sigma.
    c / sigma_m: alignment constant and AWGN std. self_scale / m_scale /
    listen: the per-receiver vectors of the unified update (defaults:
    full self-correction, AWGN scaled by 1/(c (N - 1)), everyone
    listening). noisy=False skips the noise (gossip).

    A stack of R rounds takes p, g [R, N, d], W [R, N, N], amp and the
    vectors [R, N], c, sigma_m and seed [R] (each replicate its own seed,
    its counters from 0): one launch, replicate r bitwise the round of
    replicate r's operands.

    col0 / counter_width: the column-window hooks for a buffer sharded
    over columns — the window's global column offset and the canonical
    noise-counter row stride (default roundup(d, 128), the stride the
    reference's CPU lowering uses).
    """
    if p.ndim not in (2, 3):
        raise ValueError(f"p must be [N, d] or [R, N, d], got "
                         f"{tuple(p.shape)}")
    *lead, N, d = p.shape
    lead = tuple(lead)
    cw = _counter_width(N, d, counter_width)
    dev = p.device
    vecs = _round_vectors(N, dev, seed, col0, amp, c, sigma_m, self_scale,
                          m_scale, listen, lead)
    W = torch.as_tensor(W, dtype=torch.float32, device=dev).contiguous()
    if W.shape != lead + (N, N):
        raise ValueError(f"W must be {list(lead + (N, N))}, got "
                         f"{tuple(W.shape)}")
    args = (p, g, *vecs, W)
    kw = dict(gamma=float(gamma), eta=float(eta), noisy=bool(noisy),
              counter_width=cw)
    if dev.type == "cuda":
        return _launch(*args, **kw)
    if dev.type == "cpu":
        return dp_mix_plain_stack(*args, **kw) if lead else dp_mix_plain(
            *args, **kw)
    raise ValueError(f"dp_mix_round has no path for device {dev}")


dp_mix_round.launches = 0


def _counter_width(N: int, d: int, counter_width) -> int:
    """The noise counters' row stride (default roundup(d, 128)), refused
    (C2) where N rows of it pass 2^31: the uint32 counters would wrap."""
    cw = _roundup(d, LANES) if counter_width is None else int(counter_width)
    if N * cw > COUNTER_LIMIT:
        raise ValueError(
            f"N * counter_width = {N} * {cw} exceeds 2^31: the uint32 noise "
            f"counters would wrap and reuse noise")
    return cw


def _round_vectors(N, dev, seed, col0, amp, c, sigma_m, self_scale, m_scale,
                   listen, lead=()):
    """(seed, col0, scal = [c, sigma_m], amp, self, m_scale, listen) as the
    kernels take them, with the defaults of ``dp_mix_round``; ``lead``
    (R,) for a stack of rounds: seed [R], scal [R, 2], the vectors [R,
    N]."""
    f32 = torch.float32
    c = _on(c, lead, f32, dev)
    scal = torch.stack([c, _on(sigma_m, lead, f32, dev)], dim=-1)
    if m_scale is None:
        m_scale = (torch.full(lead + (N,), 1.0, device=dev)
                   / (c.unsqueeze(-1) * max(N - 1, 1)))
    vec = lambda v: _on(v, lead + (N,), f32, dev)
    return (_on(seed, lead or (1,), torch.int32, dev),
            _on(col0, (1,), torch.int32, dev), scal, vec(amp),
            vec(1.0 if self_scale is None else self_scale), vec(m_scale),
            vec(1.0 if listen is None else listen))



def dp_mix_round_sparse(p, g, seed, sw, amp, c, sigma_m, *, gamma: float,
                        eta: float, self_scale=None, m_scale=None,
                        listen=None, noisy: bool = True, col0=0,
                        counter_width: Optional[int] = None) -> torch.Tensor:
    """One fused DWFL round mixed through a padded neighbor list ``sw``
    (``net.sparse.SparseW``, [N, k] leaves): O(N k d), never an [N, N]
    tensor. The contract of ``dp_mix_round`` with ``sw`` for W; the
    counter stride, ``col0``/``counter_width`` and the seed's counters are
    its, so both rounds draw the same noise fields, and the dense round is
    the sparse one's reference at small N (they differ by the order of the
    mix's sum).

    The worker axis is padded to Np = roundup(N, 8), as the reference pads
    it: a padded row gets idx 0, w 0, self_w 0 and listen 0, so it neither
    listens nor reaches a real row (no real row gathers an index >= N);
    the columns are not padded, each is independent of the others.
    """
    if p.ndim != 2:
        raise NotImplementedError(
            "a stack of rounds mixed through neighbor lists is not ported "
            "yet (ROADMAP A20)")
    N, d = p.shape
    cw = _counter_width(N, d, counter_width)
    dev = p.device
    if tuple(sw.idx.shape[:-1]) != (N,):
        raise ValueError(f"the neighbor list must be [{N}, k], got idx "
                         f"{tuple(sw.idx.shape)}")
    vecs = _round_vectors(N, dev, seed, col0, amp, c, sigma_m, self_scale,
                          m_scale, listen)
    Np = _roundup(N, SUBLANES)
    pad_rows = lambda a: (a if Np == N else torch.nn.functional.pad(
        a, (0, 0) * (a.ndim - 1) + (0, Np - N)))
    seed, col0, scal, *rows = vecs             # rows: amp, self, m_scale, listen
    rows += [sw.idx.to(device=dev, dtype=torch.int32),
             sw.w.to(device=dev, dtype=torch.float32),
             sw.self_w.to(device=dev, dtype=torch.float32)]
    args = (pad_rows(p), pad_rows(g), seed, col0, scal,
            *(pad_rows(v).contiguous() for v in rows))
    kw = dict(gamma=float(gamma), eta=float(eta), noisy=bool(noisy),
              counter_width=cw)
    if dev.type == "cuda":
        out = _launch_sparse(*args, **kw)
    elif dev.type == "cpu":
        out = dp_mix_sparse_plain(*args, **kw)
    else:
        raise ValueError(f"dp_mix_round_sparse has no path for device {dev}")
    return out if Np == N else out[:N]


dp_mix_round_sparse.launches = 0


def dp_mix_round_plan(p, g, seed, plan, *, gamma: float, eta: float,
                      col0=0, counter_width: Optional[int] = None
                      ) -> torch.Tensor:
    """MixPlan front end (core.exchange.plan_*) -> one fused round: the
    dense round for a dense W, the neighbor-list round for a SparseW."""
    from repro_torch.net.sparse import SparseW
    mix = dp_mix_round_sparse if isinstance(plan.W, SparseW) else dp_mix_round
    return mix(
        p, g, seed, plan.W, plan.amp, plan.c, plan.sigma_m,
        gamma=gamma, eta=eta, self_scale=plan.self_scale,
        m_scale=plan.m_scale, listen=plan.listen, noisy=plan.noisy,
        col0=col0, counter_width=counter_width)
