"""Exact causal attention in plain PyTorch: ``flash_attention_plain``, the
twin of the hand-written kernel (``csrc/flash_attention.cu``) and of the
reference's ``_flash_kernel`` (repro/kernels/flash_attention/
flash_attention.py).

It is what ``ops.flash_attention`` runs for a tensor on the CPU, and what
the CUDA kernel is held against on the card. Layout as the model's: q
[B, S, H, hd], k and v [B, S, Hkv, hd], H a multiple of Hkv; GQA by
``repeat_interleave`` of k and v. As the kernel does, it scales q by
1/sqrt(hd) before the product, masks to -1e30 (causal, the sliding
window, keys past S), takes the scores, the softmax and the probability
times v in float32, and returns the input's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True,
                          sliding_window: Optional[int] = None) -> torch.Tensor:
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    qf = q.float() * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
