"""xLSTM model assembly (the reference's ``repro.models.xlstm_model``):
repeating super-blocks of (r - 1) mLSTM blocks and one sLSTM block, then
the remainder as mLSTM blocks.

xLSTM[7:1] (the 1.3b card): slstm_every = 8 -> 6 super-blocks of 7 mLSTM
blocks followed by one sLSTM block each. slstm_every = 0 -> a pure mLSTM
stack. The mLSTM parameters are stacked [n_super, r - 1, ...], the sLSTM
ones [n_super, ...] and the remainder [n_rem, ...], as the reference
stacks them for ``lax.scan``; ``forward`` walks them with Python loops.
``use_pallas`` is taken and not used, as in the reference
(``repro/models/xlstm_model.py:47``): this family launches no kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X


def split_layers(cfg: ModelConfig):
    r = cfg.slstm_every
    if r == 0:
        return 0, 0, cfg.num_layers  # all mLSTM, treated as remainder stack
    n_super = cfg.num_layers // r
    return r, n_super, cfg.num_layers - n_super * r


def init(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    dtype = L._dtype(cfg.param_dtype)
    r, n_super, n_rem = split_layers(cfg)
    p = {
        "embed": L.embed_init(generator, cfg, dtype, device),
        "final_norm": L.norm_init(cfg, dtype, device),
    }
    if n_super:
        p["mlstm"] = X.mlstm_block_init(generator, cfg, dtype, device,
                                        stack=(n_super, r - 1))
        p["slstm"] = X.slstm_block_init(generator, cfg, dtype, device,
                                        stack=(n_super,))
    if n_rem:
        p["mlstm_rem"] = X.mlstm_block_init(generator, cfg, dtype, device,
                                            stack=(n_rem,))
    return p


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, use_pallas: bool = False):
    """Returns (logits, cache). Prefill returns {"mlstm": [n_super, r - 1,
    ...] or None, "slstm": [n_super, ...] or None, "mlstm_rem": [n_rem,
    ...] or None}; decode updates the cache it is given in place and
    returns it; train returns None."""
    x = T._embed_inputs(params, batch, cfg)
    r, n_super, n_rem = split_layers(cfg)
    decode = mode == "decode"

    def at(tree, *idx):
        for i in idx:
            tree = T.layer(tree, i)
        return tree

    m_caches, s_caches, r_caches = [], [], []
    mlstm = T.unstack(params["mlstm"], n_super) if n_super else []
    slstm = T.unstack(params["slstm"], n_super) if n_super else []
    for s in range(n_super):
        for i, p in enumerate(T.unstack(mlstm[s], r - 1)):
            x, c = X.mlstm_block_apply(
                p, x, cfg, mode,
                cache=at(cache["mlstm"], s, i) if decode else None)
            m_caches.append(c)
        x, c = X.slstm_block_apply(
            slstm[s], x, cfg, mode,
            cache=at(cache["slstm"], s) if decode else None)
        s_caches.append(c)
    rem = T.unstack(params["mlstm_rem"], n_rem) if n_rem else []
    for i, p in enumerate(rem):
        x, c = X.mlstm_block_apply(
            p, x, cfg, mode,
            cache=at(cache["mlstm_rem"], i) if decode else None)
        r_caches.append(c)

    if mode == "prefill":
        new_cache = {"mlstm": None, "slstm": None, "mlstm_rem": None}
        if n_super:
            new_cache["mlstm"] = {key: t.unflatten(0, (n_super, r - 1))
                                  for key, t in T.stack(m_caches).items()}
            new_cache["slstm"] = T.stack(s_caches)
        if n_rem:
            new_cache["mlstm_rem"] = T.stack(r_caches)
    elif decode:
        new_cache = cache
    else:
        new_cache = None

    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), new_cache
