"""Whisper-style encoder-decoder transformer (the reference's
``repro.models.encdec``).

The mel-spectrogram and conv feature extractor is a stub, as in the
reference: the encoder takes precomputed frame embeddings
``batch["embeds"]`` [B, encoder_seq_len, d_model]. The encoder is
bidirectional self-attention (no mask, no RoPE, learned ``enc_pos``
added to the frames); the decoder is causal self-attention with learned
positions, then cross-attention to the encoder's output, then the MLP.
Decode caches the encoder's output and each layer's self-attention k/v;
the cross-attention's k/v are projected from the encoder's output at
every step, as in the reference. ``use_pallas`` is taken and not used, as
in the reference (``repro/models/encdec.py:98``): this family launches no
kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def enc_block_init(generator, cfg: ModelConfig, dtype, device, stack=()):
    return {
        "norm1": L.norm_init(cfg, dtype, device, stack),
        "attn": L.attention_init(generator, cfg, dtype, device, stack),
        "norm2": L.norm_init(cfg, dtype, device, stack),
        "mlp": L.mlp_init(generator, cfg, dtype, device, stack=stack),
    }


def enc_block_apply(params, x, cfg: ModelConfig):
    """Bidirectional self-attention (no mask, no rope), then the MLP."""
    hd = cfg.resolved_head_dim
    xn = L.norm_apply(params["norm1"], x, cfg)
    q, k, v = L._project_qkv(params["attn"], xn, cfg)
    scores = L._gqa_scores(q, k) / math.sqrt(hd)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    o = L._gqa_out(probs, v, cfg.num_heads).reshape(x.shape[0], x.shape[1], -1)
    x = x + o @ params["attn"]["wo"]
    return x + L.mlp_apply(params["mlp"], L.norm_apply(params["norm2"], x, cfg),
                           cfg)


def dec_block_init(generator, cfg: ModelConfig, dtype, device, stack=()):
    return {
        "norm1": L.norm_init(cfg, dtype, device, stack),
        "self_attn": L.attention_init(generator, cfg, dtype, device, stack),
        "norm2": L.norm_init(cfg, dtype, device, stack),
        "cross_attn": L.cross_attention_init(generator, cfg, dtype, device,
                                             stack),
        "norm3": L.norm_init(cfg, dtype, device, stack),
        "mlp": L.mlp_init(generator, cfg, dtype, device, stack=stack),
    }


def dec_block_apply(params, x, enc_out, cfg: ModelConfig, positions, mode: str,
                    cache=None, cache_index=None):
    h, new_self = L.attention_apply(
        params["self_attn"], L.norm_apply(params["norm1"], x, cfg), cfg,
        positions, mode=mode, cache=cache, cache_index=cache_index)
    x = x + h
    x = x + L.cross_attention_apply(
        params["cross_attn"], L.norm_apply(params["norm2"], x, cfg), enc_out, cfg)
    x = x + L.mlp_apply(params["mlp"], L.norm_apply(params["norm3"], x, cfg), cfg)
    return x, new_self


def init(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    dtype = L._dtype(cfg.param_dtype)
    enc_pos = torch.randn((cfg.encoder_seq_len, cfg.d_model),
                          generator=generator, device=device) * 0.02
    return {
        "embed": L.embed_init(generator, cfg, dtype, device),  # tokens + pos
        "enc_pos": enc_pos.to(dtype),
        "enc_blocks": enc_block_init(generator, cfg, dtype, device,
                                     stack=(cfg.num_encoder_layers,)),
        "enc_norm": L.norm_init(cfg, dtype, device),
        "dec_blocks": dec_block_init(generator, cfg, dtype, device,
                                     stack=(cfg.num_layers,)),
        "final_norm": L.norm_init(cfg, dtype, device),
    }


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: [B, encoder_seq_len, d] -> the encoder's output, same shape."""
    x = frames.to(L._dtype(cfg.compute_dtype)) + params["enc_pos"][None]
    for p in T.unstack(params["enc_blocks"], cfg.num_encoder_layers):
        x = enc_block_apply(p, x, cfg)
    return L.norm_apply(params["enc_norm"], x, cfg)


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, use_pallas: bool = False):
    """batch: {"embeds": encoder frames, "tokens": decoder tokens}; decode
    takes the tokens alone and the cache {"enc_out": [B, Se, d], "self":
    stacked k/v}, updates its "self" in place and returns it. Returns
    (logits, cache): prefill's cache is {"enc_out", "self"}, train's
    None."""
    decode = mode == "decode"
    enc_out = cache["enc_out"] if decode else encode(params, batch["embeds"], cfg)

    tokens = batch["tokens"]
    x = L.embed_apply(params["embed"], tokens, cfg).to(L._dtype(cfg.compute_dtype))
    B, Sq = x.shape[0], x.shape[1]
    offset = int(cache_index) if decode else 0
    pe = params["embed"]["pos"][offset:offset + Sq]
    positions = (torch.arange(Sq, device=x.device) + offset)[None].expand(B, Sq)
    x = x + pe[None].to(x.dtype)

    caches = []
    for i, p in enumerate(T.unstack(params["dec_blocks"], cfg.num_layers)):
        x, c = dec_block_apply(p, x, enc_out, cfg,
                               positions, mode,
                               cache=T.layer(cache["self"], i) if decode else None,
                               cache_index=cache_index)
        caches.append(c)
    if mode == "prefill":
        new_cache = {"enc_out": enc_out, "self": T.stack(caches)}
    elif decode:
        new_cache = cache
    else:
        new_cache = None

    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), new_cache
