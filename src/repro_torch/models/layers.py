"""Foundational layers of the LM families (the reference's
``repro.models.layers``): norms, rotary embeddings, attention, MLPs,
embeddings.

Functional style as in the reference: ``*_init`` builds a parameter tree
of plain dicts with the reference's keys, ``*_apply`` consumes it, so the
trees are what the DWFL protocol perturbs and exchanges. Initializers
draw from an explicit ``torch.Generator`` at the reference's scales
(dense weights 1/sqrt(in), embeddings 0.02); the numbers differ from
``jax.random``'s, and the tests convert the reference's parameters
instead (``convert.lm_params_from_jax``).

Attention: a plain masked-softmax path for S <= 1024, the block-chunked
exact-causal path above it, the single-query cache path for decode (with
the ring-buffer cache of sliding-window configs), and with
``use_pallas=True`` the flash-attention kernel
(``kernels/flash_attention/ops.py``: the CUDA kernel on the card, its
plain twin on the CPU). Decode writes the new token's k/v into the cache
it is given, in place, and returns that cache.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, stack: Tuple[int, ...] = ()) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(in_dim); ``stack`` prepends layer
    axes (the reference's vmapped ``stacked`` init)."""
    w = torch.randn(stack + (in_dim, out_dim), generator=generator,
                    device=device)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, dtype, device, stack: Tuple[int, ...] = ()):
    shape = stack + (cfg.d_model,)
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.norm_type == "nonparametric_ln":  # olmo: no affine params
        return {}
    raise ValueError(cfg.norm_type)


def norm_apply(params, x: torch.Tensor, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        y = y * params["scale"].float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm_type == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE and qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """1 / theta^(i / half) in float32, made on the device (a fill, not a
    copy from the host, which would wait for the stream)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def _rotate_half(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """ang: [..., S, 1, half] angles broadcast over the heads."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] integer."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)            # [half]
    ang = positions[..., None].float() * freqs                   # [..., S, half]
    return _rotate_half(x, ang[..., None, :]).to(x.dtype)


def mrope_sections_for(head_dim: int, sections: Tuple[int, ...]) -> Tuple[int, ...]:
    """Scale the (t,h,w) section split to this head_dim's half-dim."""
    half = head_dim // 2
    total = sum(sections)
    scaled = [max(1, (s * half) // total) for s in sections]
    scaled[0] += half - sum(scaled)
    return tuple(scaled)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor, theta: float,
                sections: Tuple[int, ...]):
    """qwen2-vl M-RoPE. positions_thw: [3, ..., S] (temporal, height, width
    ids). Each rotary half-dim takes its position from one of the three
    streams according to ``sections``; equal t == h == w ids reduce it to
    ordinary RoPE."""
    secs = mrope_sections_for(x.shape[-1], sections)
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    # per half-dim position: stream i's ids repeated over its section
    pos = positions_thw.float()                                  # [3, ..., S]
    pos_per_dim = torch.cat([pos[i][..., None].expand(*pos.shape[1:], n)
                             for i, n in enumerate(secs)], dim=-1)  # [..., S, half]
    ang = pos_per_dim * freqs
    return _rotate_half(x, ang[..., None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_init(generator, cfg: ModelConfig, dtype, device,
                   stack: Tuple[int, ...] = ()):
    hd = cfg.resolved_head_dim
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(generator, d, H * hd, dtype, device, stack),
        "wk": dense_init(generator, d, Hkv * hd, dtype, device, stack),
        "wv": dense_init(generator, d, Hkv * hd, dtype, device, stack),
        "wo": dense_init(generator, H * hd, d, dtype, device, stack),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            p[name] = torch.zeros(stack + (width,), dtype=dtype, device=device)
    return p


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    B, S = x.shape[0], x.shape[1]
    return (q.reshape(B, S, cfg.num_heads, hd),
            k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def _rotate(q, k, cfg: ModelConfig, positions):
    if cfg.use_mrope:  # positions: [3, B, S]
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif not cfg.learned_pos_emb:  # whisper: positions are embedded
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,Sq,H,hd], k: [B,Sk,Hkv,hd] -> scores [B,H,Sq,Sk] with GQA groups."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k)
    return s.reshape(B, H, Sq, k.shape[1])


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, H: int) -> torch.Tensor:
    """probs: [B,H,Sq,Sk], v: [B,Sk,Hkv,hd] -> [B,Sq,H,hd]."""
    B, _, Sq, Sk = probs.shape
    Hkv = v.shape[2]
    pg = probs.reshape(B, Hkv, H // Hkv, Sq, Sk)
    o = torch.einsum("bkgqs,bskd->bqkgd", pg, v)
    return o.reshape(B, Sq, H, v.shape[-1])


def _masked_softmax_out(q, k, v, cfg: ModelConfig, qpos, kpos):
    hd = q.shape[-1]
    scores = _gqa_scores(q, k) / math.sqrt(hd)
    mask = kpos[None, :] <= qpos[:, None]
    if cfg.sliding_window is not None:
        mask &= kpos[None, :] > qpos[:, None] - cfg.sliding_window
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF).float(),
                          dim=-1).to(q.dtype)
    return _gqa_out(probs, v, cfg.num_heads)


def _plain_causal_attention(q, k, v, cfg: ModelConfig, q_offset: int = 0):
    Sq, Sk = q.shape[1], k.shape[1]
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    return _masked_softmax_out(q, k, v, cfg, qpos, kpos)


def _chunked_causal_attention(q, k, v, cfg: ModelConfig, q_block: int = 1024):
    """Exact-causal attention a query block at a time: block i attends only
    to KV[lo : (i+1) q_block], lo the start of its window (0 without
    one), so O(S q_block) scores are live."""
    S = q.shape[1]
    n_blocks = S // q_block
    if n_blocks * q_block != S:
        raise ValueError(f"chunked attention needs S % {q_block} == 0, got S={S}")
    outs = []
    for i in range(n_blocks):
        lo = 0
        if cfg.sliding_window is not None:
            lo = max(0, (i + 1) * q_block - cfg.sliding_window - q_block)
        hi = (i + 1) * q_block
        qpos = torch.arange(i * q_block, hi, device=q.device)
        kpos = torch.arange(lo, hi, device=q.device)
        outs.append(_masked_softmax_out(q[:, i * q_block:hi], k[:, lo:hi],
                                        v[:, lo:hi], cfg, qpos, kpos))
    return torch.cat(outs, dim=1)


def _decode_attention(q, k_cache, v_cache, cache_len, cfg: ModelConfig,
                      window_pos=None):
    """Single-token attention against a cache. q: [B,1,H,hd]; caches
    [B,Smax,Hkv,hd] with the new token's k/v already written; cache_len:
    the count of valid entries. ``window_pos`` (ring-buffer caches): the
    absolute position held by each slot, -1 where empty."""
    hd = q.shape[-1]
    scores = _gqa_scores(q, k_cache) / math.sqrt(hd)             # [B,H,1,Smax]
    if window_pos is None:
        valid = torch.arange(k_cache.shape[1], device=q.device) < cache_len
    else:
        valid = window_pos >= 0
    probs = torch.softmax(scores.masked_fill(~valid, NEG_INF).float(),
                          dim=-1).to(q.dtype)
    return _gqa_out(probs, v_cache, cfg.num_heads)


def attention_apply(params, x: torch.Tensor, cfg: ModelConfig, positions, *,
                    mode: str, cache: Optional[dict] = None, cache_index=None,
                    use_pallas: bool = False):
    """mode: 'train' | 'prefill' | 'decode'. Returns (y, cache): prefill
    returns the layer's k/v, decode the cache it updated in place."""
    B, S = x.shape[0], x.shape[1]
    q, k, v = _project_qkv(params, x, cfg)
    q, k = _rotate(q, k, cfg, positions)

    new_cache = None
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        idx = int(cache_index)
        if "pos" in cache:  # ring buffer (sliding window)
            slot = idx % cache["k"].shape[1]
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            cache["pos"][slot] = idx
            o = _decode_attention(q, cache["k"], cache["v"], idx + 1, cfg,
                                  window_pos=cache["pos"])
        else:
            cache["k"][:, idx:idx + 1] = k
            cache["v"][:, idx:idx + 1] = v
            o = _decode_attention(q, cache["k"], cache["v"], idx + 1, cfg)
        new_cache = cache
    else:
        if use_pallas:
            from repro_torch.kernels.flash_attention import ops as fa_ops
            o = fa_ops.flash_attention(q, k, v, causal=True,
                                       sliding_window=cfg.sliding_window)
        elif S > 1024:
            o = _chunked_causal_attention(q, k, v, cfg)
        else:
            o = _plain_causal_attention(q, k, v, cfg)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}

    y = o.reshape(B, S, -1) @ params["wo"]
    return y, new_cache


def cross_attention_init(generator, cfg: ModelConfig, dtype, device,
                         stack: Tuple[int, ...] = ()):
    return attention_init(generator, cfg.replace(qkv_bias=False), dtype,
                          device, stack)


def cross_attention_apply(params, x, enc_out, cfg: ModelConfig):
    """Encoder-decoder cross attention (whisper): no causal mask, no rope."""
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    Se = enc_out.shape[1]
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (enc_out @ params["wk"]).reshape(B, Se, cfg.num_kv_heads, hd)
    v = (enc_out @ params["wv"]).reshape(B, Se, cfg.num_kv_heads, hd)
    scores = _gqa_scores(q, k) / math.sqrt(hd)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    o = _gqa_out(probs, v, cfg.num_heads)
    return o.reshape(B, S, -1) @ params["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(generator, cfg: ModelConfig, dtype, device,
             d_ff: Optional[int] = None, stack: Tuple[int, ...] = ()):
    d_ff = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": dense_init(generator, d, d_ff, dtype, device, stack),
                "w_up": dense_init(generator, d, d_ff, dtype, device, stack),
                "w_down": dense_init(generator, d_ff, d, dtype, device, stack)}
    return {"w_up": dense_init(generator, d, d_ff, dtype, device, stack),
            "w_down": dense_init(generator, d_ff, d, dtype, device, stack)}


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig):
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    if cfg.mlp_type == "geglu":
        return (F.gelu(x @ params["w_gate"], approximate="tanh")
                * (x @ params["w_up"])) @ params["w_down"]
    return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embed_init(generator, cfg: ModelConfig, dtype, device):
    p = {"tok": (torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                             device=device) * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  dtype, device)
    if cfg.learned_pos_emb:
        max_pos = 65536 if cfg.is_encoder_decoder else 32768
        p["pos"] = (torch.randn((max_pos, cfg.d_model), generator=generator,
                                device=device) * 0.02).to(dtype)
    return p


def embed_apply(params, tokens: torch.Tensor, cfg: ModelConfig):
    x = params["tok"][tokens]
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype first, as the
        # reference does; a Python number needs no copy to the device
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def unembed_apply(params, x: torch.Tensor, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return x @ params["tok"].T
    return x @ params["unembed"]
