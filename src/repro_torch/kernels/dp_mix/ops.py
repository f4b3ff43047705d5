"""Wrappers of the fused DWFL round: ``dp_mix_round`` over the flat [N, d]
buffer with a dense W, ``dp_mix_round_sparse`` with a padded neighbor list
(``net.sparse.SparseW``), ``dp_mix_round_plan`` over a ``MixPlan`` (either
W), the two halves of a worker shard's sparse round (``dp_mix_prep_rows``,
``dp_mix_gather_rows``), and ``seed_from_key``.

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
A row window checks the global rows, (row0 + n) * counter_width.

The sparse round takes a stack the same way (p, g [R, N, d], a SparseW
of [R, N, k] leaves): one ``dp_mix_prep`` and one ``dp_mix_gather``
launch for all R, replicate r bitwise its own round; its plain version
is ``dp_mix.dp_mix_sparse_plain_stack``.

A worker shard (``repro_torch.shard.worker``) holds rows [row0, row0 +
Nb) of an N-row population and splits the sparse round in two:
``dp_mix_prep_rows`` draws its rows' noise with global counters into a
float32 workspace [2, Nb, d] (z, then n/c); the caller gathers every
shard's z into one [N, d] tensor; ``dp_mix_gather_rows`` forms the
shard's receivers from it, their neighbors by global index. Stitched,
the shards are bitwise ``dp_mix_round_sparse`` on the whole population
(the same kernels, ``row0`` = 0 and the workspace's own z for the whole
round); their plain versions are ``dp_mix.dp_mix_prep_plain`` and
``dp_mix.dp_mix_gather_plain``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_mix.dp_mix import (dp_mix_gather_plain,
                                              dp_mix_plain, dp_mix_plain_stack,
                                              dp_mix_prep_plain,
                                              dp_mix_sparse_plain,
                                              dp_mix_sparse_plain_stack)

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
SPARSE_ARGTYPES = ([ctypes.c_int] + [_PTR] * 14 + [ctypes.c_int] * 5
                   + [ctypes.c_uint, ctypes.c_float, ctypes.c_float,
                      ctypes.c_int, _PTR])
# dp_mix_prep_launch's parameters, in order
PREP_ARGTYPES = ([ctypes.c_int] + [_PTR] * 7 + [ctypes.c_int] * 3
                 + [ctypes.c_uint, ctypes.c_float, ctypes.c_int, _PTR])
# dp_mix_gather_launch's parameters, in order
GATHER_ARGTYPES = ([ctypes.c_int] + [_PTR] * 15 + [ctypes.c_int] * 5
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
        for name, types in (("dp_mix_sparse_launch", SPARSE_ARGTYPES),
                            ("dp_mix_prep_launch", PREP_ARGTYPES),
                            ("dp_mix_gather_launch", GATHER_ARGTYPES)):
            getattr(lib, name).argtypes = types
            getattr(lib, name).restype = ctypes.c_int
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
                   w, self_w, *, gamma, eta, noisy, counter_width, row0=0
                   ) -> torch.Tensor:
    """dp_mix_prep then dp_mix_gather over the float32 workspace [2, N, d]
    (z, then the DP noise n/c); ``row0`` offsets the noise counters'
    rows. A stack [R, N, d] of R rounds is the same two launches over a
    workspace [R, 2, N, d], the replicate a grid axis of both."""
    *lead, N, d = p.shape
    lead = tuple(lead)
    R = lead[0] if lead else 1
    k = idx.shape[-1] if idx.ndim == len(lead) + 2 else -1
    _check(p, _vectors(p, g, seed, col0, scal, amp, selfs, mscale, listen)
           + (("idx", idx, lead + (N, k), torch.int32),
              ("w", w, lead + (N, k), torch.float32),
              ("self_w", self_w, lead + (N,), torch.float32)))
    p, g = p.contiguous(), g.contiguous()
    out = torch.empty_like(p)
    ws = torch.empty(R * 2 * N * d, dtype=torch.float32, device=p.device)
    lib = _library()
    rc = lib.dp_mix_sparse_launch(
        _DTYPES[p.dtype], p.data_ptr(), g.data_ptr(), out.data_ptr(),
        idx.data_ptr(), w.data_ptr(), self_w.data_ptr(), amp.data_ptr(),
        selfs.data_ptr(), mscale.data_ptr(), listen.data_ptr(),
        scal.data_ptr(), seed.data_ptr(), col0.data_ptr(), ws.data_ptr(),
        R, N, d, k, int(row0), counter_width, gamma, eta, int(noisy),
        torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, rc)
    dp_mix_round_sparse.launches += 1
    return out


def _launch_prep(p, g, seed, col0, scal, amp, *, gamma, noisy, counter_width,
                 row0) -> torch.Tensor:
    """dp_mix_prep over a shard's rows into a new workspace [2, Nb, d]."""
    Nb, d = p.shape
    _check(p, (("g", g, (Nb, d), p.dtype), ("amp", amp, (Nb,), torch.float32),
               ("scal", scal, (2,), torch.float32),
               ("seed", seed, (1,), torch.int32),
               ("col0", col0, (1,), torch.int32)))
    ws = torch.empty((2, Nb, d), dtype=torch.float32, device=p.device)
    lib = _library()
    rc = lib.dp_mix_prep_launch(
        _DTYPES[p.dtype], p.data_ptr(), g.data_ptr(), amp.data_ptr(),
        scal.data_ptr(), seed.data_ptr(), col0.data_ptr(), ws.data_ptr(),
        Nb, d, int(row0), counter_width, gamma, int(noisy),
        torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, rc)
    dp_mix_prep_rows.launches += 1
    return ws


def _launch_gather(p, g, ws, z_src, seed, col0, scal, amp, selfs, mscale,
                   listen, idx, w, self_w, *, gamma, eta, noisy,
                   counter_width, row0) -> torch.Tensor:
    """dp_mix_gather for a shard's receivers from its workspace and the
    gathered z_src [N, d]."""
    Nb, d = p.shape
    k = idx.shape[1] if idx.ndim == 2 else -1
    _check(p, _vectors(p, g, seed, col0, scal, amp, selfs, mscale, listen)
           + (("ws", ws, (2, Nb, d), torch.float32),
              ("z_src", z_src, (z_src.shape[0], d), torch.float32),
              ("idx", idx, (Nb, k), torch.int32),
              ("w", w, (Nb, k), torch.float32),
              ("self_w", self_w, (Nb,), torch.float32)))
    out = torch.empty_like(p)
    lib = _library()
    rc = lib.dp_mix_gather_launch(
        _DTYPES[p.dtype], p.data_ptr(), g.data_ptr(), out.data_ptr(),
        idx.data_ptr(), w.data_ptr(), self_w.data_ptr(), amp.data_ptr(),
        selfs.data_ptr(), mscale.data_ptr(), listen.data_ptr(),
        scal.data_ptr(), seed.data_ptr(), col0.data_ptr(), ws.data_ptr(),
        z_src.data_ptr(), Nb, z_src.shape[0], d, k, int(row0),
        counter_width, gamma, eta, int(noisy),
        torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, rc)
    dp_mix_gather_rows.launches += 1
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


def _counter_width(N: int, d: int, counter_width, row0: int = 0) -> int:
    """The noise counters' row stride (default roundup(d, 128)), refused
    (C2) where the global rows, row0 + N of it, pass 2^31: the uint32
    counters would wrap."""
    cw = _roundup(d, LANES) if counter_width is None else int(counter_width)
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    if (row0 + N) * cw > COUNTER_LIMIT:
        raise ValueError(
            f"N * counter_width = {row0 + N} * {cw} exceeds 2^31: the uint32 "
            f"noise counters would wrap and reuse noise")
    return cw


def check_counter_limit(N: int, d: int) -> int:
    """The counter width of an [N, d] buffer's rounds, roundup(d, 128);
    raises the ValueError of C2 where N of it pass 2^31 (a caller can
    refuse a run before it allocates anything)."""
    return _counter_width(N, d, None)


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
                        counter_width: Optional[int] = None,
                        row0: int = 0) -> torch.Tensor:
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

    ``row0`` offsets the noise counters' rows (the reference's
    ``dp_mix_sparse_jnp(row0=)``): the rows draw the noise of global rows
    [row0, row0 + N); the neighbor list indexes this buffer's rows.

    A stack of R rounds (the fleet's) takes p, g [R, N, d], ``sw`` with
    [R, N, k] leaves, amp and the vectors [R, N], c, sigma_m and seed [R]:
    one prep and one gather launch for all R (one count), each
    replicate's counters from 0 under its own seed, padded to Np rows on
    its own, and replicate r bitwise the round of replicate r's operands
    (on the CPU ``dp_mix.dp_mix_sparse_plain_stack``).
    """
    if p.ndim not in (2, 3):
        raise ValueError(f"p must be [N, d] or [R, N, d], got "
                         f"{tuple(p.shape)}")
    *lead, N, d = p.shape
    lead = tuple(lead)
    cw = _counter_width(N, d, counter_width, int(row0))
    dev = p.device
    if tuple(sw.idx.shape[:-1]) != lead + (N,):
        raise ValueError(f"the neighbor list must be {list(lead + (N,))} + "
                         f"[k], got idx {tuple(sw.idx.shape)}")
    vecs = _round_vectors(N, dev, seed, col0, amp, c, sigma_m, self_scale,
                          m_scale, listen, lead)
    Np = _roundup(N, SUBLANES)
    # the worker axis, len(lead), padded to Np
    pad_rows = lambda a: (a if Np == N else torch.nn.functional.pad(
        a, (0, 0) * (a.ndim - 1 - len(lead)) + (0, Np - N)))
    seed, col0, scal, *rows = vecs             # rows: amp, self, m_scale, listen
    rows += [sw.idx.to(device=dev, dtype=torch.int32),
             sw.w.to(device=dev, dtype=torch.float32),
             sw.self_w.to(device=dev, dtype=torch.float32)]
    args = (pad_rows(p), pad_rows(g), seed, col0, scal,
            *(pad_rows(v).contiguous() for v in rows))
    kw = dict(gamma=float(gamma), eta=float(eta), noisy=bool(noisy),
              counter_width=cw, row0=int(row0))
    if dev.type == "cuda":
        out = _launch_sparse(*args, **kw)
    elif dev.type == "cpu":
        out = (dp_mix_sparse_plain_stack if lead else dp_mix_sparse_plain)(
            *args, **kw)
    else:
        raise ValueError(f"dp_mix_round_sparse has no path for device {dev}")
    return out if Np == N else out[..., :N, :]


dp_mix_round_sparse.launches = 0


def dp_mix_prep_rows(p, g, seed, amp, c, *, gamma: float, row0: int,
                     n_workers: int, noisy: bool = True, col0=0,
                     counter_width: Optional[int] = None) -> torch.Tensor:
    """A worker shard's first half of the sparse round: p, g [Nb, d] are
    rows [row0, row0 + Nb) of an ``n_workers``-row buffer, amp [Nb] their
    DP-noise amplitudes. Returns the float32 workspace [2, Nb, d]: z = x +
    n/c, then n/c, the noise drawn with global counters (gossip: x, then
    zeros on the CPU; the card leaves the second half unwritten, and the
    gather does not read it)."""
    Nb, d = p.shape
    if row0 + Nb > n_workers:
        raise ValueError(f"rows [{row0}, {row0 + Nb}) pass n_workers = "
                         f"{n_workers}")
    cw = _counter_width(n_workers, d, counter_width)
    dev = p.device
    seed_t, col0_t, scal, amp_t, *_ = _round_vectors(
        Nb, dev, seed, col0, amp, c, 0.0, None, 0.0, None)
    args = (p.contiguous(), g.contiguous(), seed_t, col0_t, scal, amp_t)
    kw = dict(gamma=float(gamma), noisy=bool(noisy), counter_width=cw,
              row0=int(row0))
    if dev.type == "cuda":
        return _launch_prep(*args, **kw)
    if dev.type == "cpu":
        return dp_mix_prep_plain(*args, **kw)
    raise ValueError(f"dp_mix_prep_rows has no path for device {dev}")


dp_mix_prep_rows.launches = 0


def dp_mix_gather_rows(p, g, ws, z_src, seed, sw, amp, c, sigma_m, *,
                       gamma: float, eta: float, row0: int, self_scale=None,
                       m_scale=None, listen=None, noisy: bool = True, col0=0,
                       counter_width: Optional[int] = None) -> torch.Tensor:
    """A worker shard's second half: its receivers, rows [row0, row0 +
    Nb) of the population, from its workspace ``ws`` (``dp_mix_prep_rows``)
    and z_src [N, d] float32, every shard's z gathered in row order. ``sw``
    is the shard's rows of the neighbor list (idx global, [Nb, k]); amp
    and the vectors are the shard's rows ([Nb]; m_scale has no default
    here, the population's N being the shard's to know)."""
    Nb, d = p.shape
    N = z_src.shape[0]
    if tuple(sw.idx.shape[:-1]) != (Nb,):
        raise ValueError(f"the neighbor list must be [{Nb}, k], got idx "
                         f"{tuple(sw.idx.shape)}")
    if m_scale is None:
        raise ValueError("dp_mix_gather_rows needs m_scale (the shard's rows)")
    cw = _counter_width(N, d, counter_width)
    dev = p.device
    vecs = _round_vectors(Nb, dev, seed, col0, amp, c, sigma_m, self_scale,
                          m_scale, listen)
    args = (p.contiguous(), g.contiguous(), ws, z_src.contiguous(), *vecs,
            sw.idx.to(device=dev, dtype=torch.int32).contiguous(),
            sw.w.to(device=dev, dtype=torch.float32).contiguous(),
            sw.self_w.to(device=dev, dtype=torch.float32).contiguous())
    kw = dict(gamma=float(gamma), eta=float(eta), noisy=bool(noisy),
              counter_width=cw, row0=int(row0))
    if dev.type == "cuda":
        return _launch_gather(*args, **kw)
    if dev.type == "cpu":
        return dp_mix_gather_plain(*args, **kw)
    raise ValueError(f"dp_mix_gather_rows has no path for device {dev}")


dp_mix_gather_rows.launches = 0


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
