"""zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block
(the reference's ``repro.models.hybrid``).

The attention(+MLP) block's parameters are shared by all its applications
(one after every ``shared_attn_every`` Mamba layers), each application
with its own KV cache. Layout: ``n_super`` super-blocks of (k Mamba layers
+ the shared block), then ``n_rem`` trailing Mamba layers. The Mamba
parameters are stacked [n_super, k, ...] and [n_rem, ...] as the
reference stacks them for ``lax.scan``; ``forward`` walks them with Python
loops. The shared block is called without ``use_pallas``, as the
reference calls it: only the Mamba blocks take the kernel path.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T


def split_layers(cfg: ModelConfig):
    k = cfg.shared_attn_every
    n_super = cfg.num_layers // k
    n_rem = cfg.num_layers - n_super * k
    return k, n_super, n_rem


def init(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    dtype = L._dtype(cfg.param_dtype)
    k, n_super, n_rem = split_layers(cfg)
    p = {
        "embed": L.embed_init(generator, cfg, dtype, device),
        "mamba": S.ssm_block_init(generator, cfg, dtype, device,
                                  stack=(n_super, k)),
        "shared_attn": T.block_init(generator, cfg, dtype, device),  # ONE set
        "final_norm": L.norm_init(cfg, dtype, device),
    }
    if n_rem:
        p["mamba_rem"] = S.ssm_block_init(generator, cfg, dtype, device,
                                          stack=(n_rem,))
    return p


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, use_pallas: bool = False):
    """Returns (logits, cache). Prefill returns {"mamba": [n_super, k, ...],
    "attn": [n_super, ...], "mamba_rem": [n_rem, ...] or None}; decode
    updates the cache it is given in place and returns it."""
    x = T._embed_inputs(params, batch, cfg)
    B, Sq = x.shape[0], x.shape[1]
    offset = cache_index if mode == "decode" else 0
    positions = T._positions_for(batch, cfg, Sq, B, x.device, offset=offset)
    k, n_super, n_rem = split_layers(cfg)
    shared = params["shared_attn"]
    decode = mode == "decode"

    m_caches, a_caches = [], []
    supers = T.unstack(params["mamba"], n_super) if n_super else []
    for s, mamba_p in enumerate(supers):
        for i, p in enumerate(T.unstack(mamba_p, k)):
            mc = T.layer(T.layer(cache["mamba"], s), i) if decode else None
            x, c = S.ssm_block_apply(p, x, cfg, mode,
                                     cache=mc, use_pallas=use_pallas)
            m_caches.append(c)
        ac = T.layer(cache["attn"], s) if decode else None
        x, c = T.block_apply(shared, x, cfg, positions, mode, cache=ac,
                             cache_index=cache_index)
        a_caches.append(c)
    r_caches = []
    rem = T.unstack(params["mamba_rem"], n_rem) if n_rem else []
    for i, p in enumerate(rem):
        rc = T.layer(cache["mamba_rem"], i) if decode else None
        x, c = S.ssm_block_apply(p, x, cfg, mode,
                                 cache=rc, use_pallas=use_pallas)
        r_caches.append(c)

    if mode == "prefill":
        new_cache = {
            "mamba": {key: t.unflatten(0, (n_super, k))
                      for key, t in T.stack(m_caches).items()},
            "attn": T.stack(a_caches),
            "mamba_rem": T.stack(r_caches) if n_rem else None,
        }
    elif decode:
        new_cache = cache
    else:
        new_cache = None

    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), new_cache
