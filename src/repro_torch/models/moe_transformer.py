"""MoE decoder transformer, qwen3-moe and deepseek-moe (the reference's
``repro.models.moe_transformer``).

The attention trunk of the dense transformer with a routed MoE FFN
(``models.moe``), optional shared experts and optional leading dense
blocks (deepseek-moe: the first layer is dense). The load-balance aux
loss is summed over the MoE blocks, divided by ``num_layers``, and
returned beside the logits. Block parameters are stacked [L, ...] as the
reference stacks them for ``lax.scan``; ``forward`` walks them with
Python loops.

``use_pallas`` is taken and not used, as in the reference
(``repro/models/moe_transformer.py:57``): neither the attention nor the
dense blocks are handed it, so this family launches no kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T


def moe_block_init(generator, cfg: ModelConfig, dtype, device, stack=()):
    return {
        "norm1": L.norm_init(cfg, dtype, device, stack),
        "attn": L.attention_init(generator, cfg, dtype, device, stack),
        "norm2": L.norm_init(cfg, dtype, device, stack),
        "moe": M.moe_init(generator, cfg, dtype, device, stack),
    }


def moe_block_apply(params, x, cfg: ModelConfig, positions, mode: str,
                    cache=None, cache_index=None):
    h, new_cache = L.attention_apply(
        params["attn"], L.norm_apply(params["norm1"], x, cfg), cfg, positions,
        mode=mode, cache=cache, cache_index=cache_index)
    x = x + h
    y, aux = M.moe_apply(params["moe"], L.norm_apply(params["norm2"], x, cfg),
                         cfg)
    return x + y, new_cache, aux


def init(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    dtype = L._dtype(cfg.param_dtype)
    n_dense = cfg.first_dense_layers
    p = {
        "embed": L.embed_init(generator, cfg, dtype, device),
        "moe_blocks": moe_block_init(generator, cfg, dtype, device,
                                     stack=(cfg.num_layers - n_dense,)),
        "final_norm": L.norm_init(cfg, dtype, device),
    }
    if n_dense:
        p["dense_blocks"] = T.block_init(generator, cfg, dtype, device,
                                         stack=(n_dense,))
    return p


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, use_pallas: bool = False):
    """Returns (logits, cache, aux). Prefill returns {"dense": the leading
    dense blocks' stacked k/v or None, "moe": the MoE blocks'}; decode
    updates the cache it is given in place and returns it; train returns
    None."""
    x = T._embed_inputs(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    offset = cache_index if mode == "decode" else 0
    positions = T._positions_for(batch, cfg, S, B, x.device, offset=offset)
    decode = mode == "decode"

    n_dense = cfg.first_dense_layers
    d_caches = []
    dense = T.unstack(params["dense_blocks"], n_dense) if n_dense else []
    for i, p in enumerate(dense):
        x, c = T.block_apply(p, x, cfg,
                             positions, mode,
                             cache=T.layer(cache["dense"], i) if decode else None,
                             cache_index=cache_index)
        d_caches.append(c)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    m_caches = []
    for i, p in enumerate(T.unstack(params["moe_blocks"],
                                    cfg.num_layers - n_dense)):
        x, c, a = moe_block_apply(
            p, x, cfg, positions, mode,
            cache=T.layer(cache["moe"], i) if decode else None,
            cache_index=cache_index)
        aux = aux + a
        m_caches.append(c)

    if mode == "prefill":
        new_cache = {"dense": T.stack(d_caches) if n_dense else None,
                     "moe": T.stack(m_caches)}
    elif decode:
        new_cache = cache
    else:
        new_cache = None

    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = L.unembed_apply(params["embed"], x, cfg)
    return logits, new_cache, aux / cfg.num_layers
