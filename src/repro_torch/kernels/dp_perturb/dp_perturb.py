"""The fused local step with DP noise in plain PyTorch: ``dp_perturb_plain``,
the twin of the reference's interpret-mode kernel body
(repro/kernels/dp_perturb/dp_perturb.py::_dp_perturb_kernel).

It is what ``ops.sgd_update`` / ``ops.dp_perturb`` run for a tensor on the
CPU, and what the CUDA kernel (``csrc/dp_perturb.cu``) is held against on
the card. Its operation sequence is the one the reference's XLA CPU
lowering executes, found by comparing bits:

    x  = fma(-gamma, g, p)                    (XLA contracts p - gamma g)
    xt = fma(s_sig, x, G * (sigma * s_noise))  when sigma > 0, s_noise != 0
    xt = s_sig * x                             otherwise

with G the Box-Muller normal of ``noise.perturb_normals`` and sigma *
s_noise folded in float32 first (XLA's simplifier reassociates the two
constant factors). A fused multiply-add is computed through float64,
where the product is exact, so it rounds once to float64 and once to
float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import noise


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a * b.double() + c.double()).float()


def dp_perturb_plain(p, g, seed, *, gamma: float, sigma: float, s_sig: float,
                     s_noise: float):
    """p, g: a leaf of any shape (float32 or bfloat16); seed: int32 scalar
    (int or tensor). Returns (x, xt) in p's dtype, computed in float32."""
    x = _fma(-_f32(gamma), g.float(), p.float())
    if sigma > 0.0 and s_noise != 0.0:
        G = noise.perturb_normals(p.numel(), torch.as_tensor(seed).reshape(-1)[0],
                                  p.device).reshape(p.shape)
        xt = _fma(_f32(s_sig), x, G * _f32(_f32(sigma) * _f32(s_noise)))
    else:
        xt = x * _f32(s_sig)
    return x.to(p.dtype), xt.to(p.dtype)
