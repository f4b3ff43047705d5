"""Wrappers of the fused local step: ``sgd_update`` (sigma = 0, the
protocol's local step with ``use_pallas=True``) and ``dp_perturb`` (local
step + DP noise + power scale), with the reference's signatures
(repro/kernels/dp_perturb/ops.py).

Dispatch is by the device of ``p``: a CUDA tensor launches the
hand-written kernel (``csrc/dp_perturb.cu``) or raises; a CPU tensor runs
the plain version (``dp_perturb.dp_perturb_plain``). There is no fallback
between the two. ``sgd_update.launches`` and ``dp_perturb.launches`` count
the kernel launches of each wrapper.

Dtype contract (the reference's): outputs carry p's dtype (float32 or
bfloat16 on the card); the arithmetic is float32. The kernel reads its
operands as flat contiguous arrays, so the wrapper makes p and g
contiguous first: an ``expand``ed view passed by its pointer would make
every worker read worker 0's memory. Noisy leaves are limited to 2^31
elements: past that the uint32 noise counters wrap and two elements would
draw the same noise.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_perturb.dp_perturb import dp_perturb_plain

COUNTER_LIMIT = 1 << 31

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
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr,
                       ctypes.c_longlong, ptr, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.dp_perturb_error_string.argtypes = [ctypes.c_int]
        lib.dp_perturb_error_string.restype = ctypes.c_char_p
    return lib


def _launch(p, g, seed, mode: int, *, gamma: float, s_sig: float = 1.0,
            noise_scale: float = 0.0):
    """One launch over the leaf; returns (x, xt or None)."""
    if p.dtype not in _DTYPES:
        raise TypeError(f"dp_perturb kernel takes float32 or bfloat16, got "
                        f"{p.dtype}")
    if (g.shape != p.shape or g.dtype != p.dtype or g.device != p.device):
        raise ValueError(f"dp_perturb operand g: want {tuple(p.shape)} "
                         f"{p.dtype} on {p.device}, got {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")
    p, g = p.contiguous(), g.contiguous()
    x = torch.empty_like(p)
    xt = None if mode == _X_ONLY else torch.empty_like(p)
    lib = _library()
    rc = lib.dp_perturb_launch(
        _DTYPES[p.dtype], mode, p.data_ptr(), g.data_ptr(), x.data_ptr(),
        None if xt is None else xt.data_ptr(), p.numel(),
        None if seed is None else seed.data_ptr(), gamma, s_sig, noise_scale,
        torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dp_perturb kernel launch failed: "
                           f"{lib.dp_perturb_error_string(rc).decode()} ({rc})")
    return x, xt


def sgd_update(p, g, gamma: float):
    """Fused SGD step (the sigma = 0 path): p - gamma g in p's dtype."""
    if p.device.type == "cuda":
        x, _ = _launch(p, g, None, _X_ONLY, gamma=float(gamma))
        sgd_update.launches += 1
        return x
    if p.device.type == "cpu":
        return dp_perturb_plain(p, g, 0, gamma=gamma, sigma=0.0, s_sig=1.0,
                                s_noise=0.0)[0]
    raise ValueError(f"sgd_update has no path for device {p.device}")


sgd_update.launches = 0


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
        out = _launch(p, g, seed, _NOISY if noisy else _SCALED,
                      gamma=float(gamma), s_sig=float(s_sig),
                      noise_scale=scale)
        dp_perturb.launches += 1
        return out
    if p.device.type == "cpu":
        return dp_perturb_plain(p, g, seed, gamma=gamma, sigma=sigma,
                                s_sig=s_sig, s_noise=s_noise)
    raise ValueError(f"dp_perturb has no path for device {p.device}")


dp_perturb.launches = 0
