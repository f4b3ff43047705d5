"""Mixture-of-Experts FFN, GShard-style capacity-based einsum dispatch (the
reference's ``repro.models.moe``).

Top-k routing with a per-(group, expert) capacity, optional shared experts
(deepseek-moe) and a load-balance auxiliary loss. Tokens are cut into
groups of ``min(GROUP_SIZE, B S)`` and each group routes independently
with capacity C = max(4, ceil(group_size * topk / E * capacity_factor)).
The expert products, the dispatch and the combine are einsums, as in the
reference: every expert runs its C slots of every group, filled or not.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

GROUP_SIZE = 256  # tokens per routing group


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype, device,
             stack=()):
    """One block's router (float32), expert stacks [E, ...] and shared
    experts; ``stack`` prepends layer axes."""
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": L.dense_init(generator, d, E, torch.float32, device, stack),
        "w_gate": L.dense_init(generator, d, ff, dtype, device, stack + (E,)),
        "w_up": L.dense_init(generator, d, ff, dtype, device, stack + (E,)),
        "w_down": L.dense_init(generator, ff, d, dtype, device, stack + (E,)),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.mlp_init(generator, cfg, dtype, device,
                                 d_ff=cfg.moe_d_ff * cfg.num_shared_experts,
                                 stack=stack)
    return p


def _capacity(group_size: int, cfg: ModelConfig) -> int:
    c = math.ceil(group_size * cfg.num_experts_per_tok
                  / cfg.num_experts * cfg.capacity_factor)
    return max(4, c)


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, largest first, the lower index
    first among equal values (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_logits: torch.Tensor, cfg: ModelConfig, capacity: int):
    """router_logits: [G, S, E] -> (dispatch [G, S, E, C] bool, combine
    [G, S, E, C] float32, aux).

    Slot-sequential greedy capacity assignment (GShard): earlier tokens and
    earlier top-k choices win capacity slots; a token past capacity is
    dropped (its combine weight is zero) and the residual carries it.
    """
    G, S, E = router_logits.shape
    k = cfg.num_experts_per_tok
    probs = torch.softmax(router_logits.float(), dim=-1)
    topk_vals, topk_idx = top_k(probs, k)                        # [G, S, k]
    topk_vals = topk_vals / topk_vals.sum(-1, keepdim=True)

    slots = torch.arange(capacity, device=probs.device)
    counts = torch.zeros((G, 1, E), dtype=torch.int32, device=probs.device)
    dispatch = torch.zeros((G, S, E, capacity), dtype=torch.bool,
                           device=probs.device)
    combine = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                          device=probs.device)
    for j in range(k):
        mask_j = F.one_hot(topk_idx[..., j], E).to(torch.int32)  # [G, S, E]
        pos_j = torch.cumsum(mask_j, dim=1, dtype=torch.int32) - mask_j + counts
        counts = counts + mask_j.sum(dim=1, keepdim=True, dtype=torch.int32)
        keep = (pos_j < capacity) & (mask_j > 0)
        d_j = (keep[..., None] & (pos_j[..., None] == slots)).float()
        dispatch |= d_j > 0
        combine = combine + topk_vals[..., j][..., None, None] * d_j

    # load-balance auxiliary loss (Switch/GShard form)
    me = probs.mean(dim=(0, 1))                    # mean router prob per expert
    ce = F.one_hot(topk_idx, E).float().sum(dim=2).mean(dim=(0, 1)) / k
    aux = E * torch.sum(me * ce)
    return dispatch, combine, aux


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux scalar)."""
    B, S, d = x.shape
    T = B * S
    gs = min(GROUP_SIZE, T)
    G = T // gs
    if G * gs != T:
        raise ValueError(f"B*S = {T} tokens do not split into routing groups "
                         f"of {gs}")
    xg = x.reshape(G, gs, d)

    logits = xg.float() @ params["router"]                       # [G, S, E]
    dispatch, combine, aux = route(logits, cfg, _capacity(gs, cfg))
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)            # [G, E, C, d]
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, params["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, params["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, params["w_down"])     # [G, E, C, d]
    y = torch.einsum("gsec,gecd->gsd", combine, ye).reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + L.mlp_apply(params["shared"], x, cfg)
    return y, aux
