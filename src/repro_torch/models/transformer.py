"""Dense decoder-only transformer, the backbone of gemma, olmo, glm4,
qwen2 and qwen2-vl (the reference's ``repro.models.transformer``).

Block parameters are stacked on a leading [L, ...] axis, as the reference
stacks them for ``lax.scan``; ``forward`` walks the layers with a Python
loop over that axis.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def block_init(generator, cfg: ModelConfig, dtype, device, stack=()):
    return {
        "norm1": L.norm_init(cfg, dtype, device, stack),
        "attn": L.attention_init(generator, cfg, dtype, device, stack),
        "norm2": L.norm_init(cfg, dtype, device, stack),
        "mlp": L.mlp_init(generator, cfg, dtype, device, stack=stack),
    }


def block_apply(params, x, cfg: ModelConfig, positions, mode: str,
                cache=None, cache_index=None, use_pallas: bool = False):
    h, new_cache = L.attention_apply(
        params["attn"], L.norm_apply(params["norm1"], x, cfg), cfg, positions,
        mode=mode, cache=cache, cache_index=cache_index, use_pallas=use_pallas)
    x = x + h
    x = x + L.mlp_apply(params["mlp"], L.norm_apply(params["norm2"], x, cfg), cfg)
    return x, new_cache


def init(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    dtype = L._dtype(cfg.param_dtype)
    return {
        "embed": L.embed_init(generator, cfg, dtype, device),
        "blocks": block_init(generator, cfg, dtype, device,
                             stack=(cfg.num_layers,)),
        "final_norm": L.norm_init(cfg, dtype, device),
    }


def layer(tree, i: int):
    """Layer i's parameters (or cache) out of the stacked [L, ...] tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """A stacked tree (nested dicts and lists of [n, ...] tensors) -> its n
    slices along the leading axis, each leaf split once by ``unbind``
    (views). Through autograd the slices' gradients come back stacked
    into one gradient a leaf; taking the slices one by one (``layer``)
    would make, for each slice, a zero-filled gradient of the whole leaf
    and add the n of them up."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: rows[i] for k, rows in parts.items()} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack(v, n) for v in tree]
        return [type(tree)(rows[i] for rows in parts) for i in range(n)]
    return list(tree.unbind(0))


def stack(caches):
    """Per-layer cache dicts -> one dict of tensors stacked on a leading
    layer axis."""
    return {key: torch.stack([c[key] for c in caches]) for key in caches[0]}


def _embed_inputs(params, batch, cfg: ModelConfig):
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = L.embed_apply(params["embed"], batch["tokens"], cfg)
    return x.to(L._dtype(cfg.compute_dtype))


def _positions_for(batch, cfg: ModelConfig, S: int, B: int, device, offset=0):
    p = (torch.arange(S, device=device) + offset)[None].expand(B, S)
    if cfg.use_mrope:
        if "positions_thw" in batch:
            return batch["positions_thw"]
        return torch.stack([p, p, p], dim=0)  # text: t == h == w
    return p


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, use_pallas: bool = False):
    """Returns (logits, cache). Prefill returns the stacked [L, B, S, Hkv,
    hd] k/v; decode updates the stacked cache it is given in place."""
    x = _embed_inputs(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    offset = int(cache_index) if mode == "decode" else 0
    positions = _positions_for(batch, cfg, S, B, x.device, offset=offset)

    caches = []
    for i, p in enumerate(unstack(params["blocks"], cfg.num_layers)):
        x, c = block_apply(p, x, cfg, positions, mode,
                           cache=None if cache is None else layer(cache, i),
                           cache_index=cache_index, use_pallas=use_pallas)
        caches.append(c)
    if mode == "prefill":
        new_cache = stack(caches)
    elif mode == "decode":
        new_cache = cache
    else:
        new_cache = None

    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), new_cache
