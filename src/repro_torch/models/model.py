"""Model dispatcher (the reference's ``repro.models.model``): one API over
the ported families.

    params          = init_params(generator, cfg, device)
    loss            = loss_fn(params, batch, cfg)
    losses          = worker_losses(worker_params, batch, cfg)   # [N]
    logits, cache   = prefill(params, batch, cfg, use_pallas=False)
    logits, cache   = decode_step(params, batch, cache, idx, cfg)
    cache           = init_cache(cfg, batch_size, max_len, device)

Ported: every family of the reference's. The MLP classifier ("mlp"), the
dense transformer ("dense" and "vlm"), the MoE transformer ("moe"), the
Mamba2 + shared-attention hybrid ("hybrid", and "ssm" with a Mamba2
state), xLSTM ("ssm" with ``slstm_every`` set or no Mamba2 state) and the
encoder-decoder ("audio"). Batches are dicts: "x"/"y" for the
classifier, "tokens" [B, S] or "embeds" [B, S, d] for the LMs, both for
the encoder-decoder (frames and decoder tokens). The MoE family's loss
adds the router's load-balance aux loss.
The classifier's losses reduce over the batch axis only, so
worker-stacked parameters give one loss per worker; ``worker_losses``
gives the [N] losses of worker-stacked parameters for every family.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (encdec, hybrid, mlp, moe_transformer, ssm,
                                transformer, xlstm, xlstm_model)
from repro_torch.runtime import resolve_device


def _module(cfg: ModelConfig):
    if cfg.family == "mlp":
        return mlp
    if cfg.family == "moe":
        return moe_transformer
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "audio" or cfg.is_encoder_decoder:
        return encdec
    if cfg.family == "ssm":
        return xlstm_model if cfg.slstm_every or cfg.ssm_state == 0 else hybrid
    if cfg.family in ("dense", "vlm"):
        return transformer
    raise ValueError(f"unknown model family {cfg.family!r}")


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    return _module(cfg).init(generator, cfg, device=resolve_device(device))


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, use_pallas: bool = False):
    """(logits, cache) of the model family."""
    return _forward(params, batch, cfg, mode, cache, cache_index,
                    use_pallas)[:2]


def _forward(params, batch, cfg: ModelConfig, mode, cache, cache_index,
             use_pallas):
    """(logits, cache, aux): aux the MoE family's load-balance loss, None
    for the others."""
    if cfg.family == "mlp":
        return (*mlp.forward(params, batch, cfg), None)
    if mode == "decode":
        cache_index = index_tensor(cache_index, cache_device(cache))
    out = _module(cfg).forward(params, batch, cfg, mode=mode, cache=cache,
                               cache_index=cache_index, use_pallas=use_pallas)
    return out if len(out) == 3 else (*out, None)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(params.numel())


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _label_log_prob(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log softmax(logits) at the label, in float32: [..., C], [...] -> [...]."""
    lf = logits.float()
    return (torch.gather(lf, -1, labels.long().unsqueeze(-1)).squeeze(-1)
            - torch.logsumexp(lf, dim=-1))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch (second-to-last) axis of -log softmax at the
    label: [..., B, C], [..., B] -> [...]."""
    return -_label_log_prob(logits, labels).mean(dim=-1)


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's LM cross-entropy: the mean over every position."""
    return -_label_log_prob(logits, labels).mean()


def loss_fn(params, batch, cfg: ModelConfig, use_pallas: bool = False):
    """Training loss: cross-entropy of the classifier, next-token
    cross-entropy of an LM, plus ``router_aux_weight`` times the
    load-balance aux loss for the MoE family."""
    if cfg.family == "mlp":
        logits, _ = mlp.forward(params, batch, cfg)
        return cross_entropy(logits, batch["y"])
    return lm_loss_and_logits(params, batch, cfg, use_pallas)[0]


def lm_loss_and_logits(params, batch, cfg: ModelConfig,
                       use_pallas: bool = False):
    """(``loss_fn``'s loss, the train forward's logits) of one LM, from one
    forward."""
    logits, _, aux = _forward(params, batch, cfg, "train", None, None,
                              use_pallas)
    if "labels" in batch:
        loss = lm_cross_entropy(logits, batch["labels"])
    else:
        loss = lm_cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
    if aux is not None:
        loss = loss + cfg.router_aux_weight * aux
    return loss, logits


def worker_losses(worker_params, batch, cfg: ModelConfig) -> torch.Tensor:
    """[N] training losses of worker-stacked parameters ([N, ...] leaves)
    on a worker-stacked batch ([N, B, ...] leaves): worker i's loss is
    ``loss_fn`` of its own parameters on its own batch, as the reference's
    vmap over workers gives it. The classifier takes every worker at once
    through batched products. An LM is run one worker at a time, each on
    its rows of the leaves (``transformer.unstack``: autograd stacks the
    workers' gradients into one [N, ...] gradient a leaf, with no
    zero-filled copy): folding the workers into the batch axis would pool the MoE's
    expert capacity and its load-balance loss over every worker's
    tokens."""
    if cfg.family == "mlp":
        return loss_fn(worker_params, batch, cfg)
    n = next(iter(batch.values())).shape[0]
    return torch.stack([
        loss_fn(p, {k: v[i] for k, v in batch.items()}, cfg)
        for i, p in enumerate(transformer.unstack(worker_params, n))])


def prefill(params, batch, cfg: ModelConfig, use_pallas: bool = False):
    return forward(params, batch, cfg, mode="prefill", use_pallas=use_pallas)


def decode_step(params, batch, cache, cache_index, cfg: ModelConfig):
    """One new token against ``cache``, which it updates in place.
    ``cache_index``, the position the token takes, is an int or a 0-d
    integer tensor on the cache's device (the reference's traced int32
    scalar); an int becomes an int32 tensor there once, at entry
    (``index_tensor``), so every layer reads a tensor and the step
    reads no value on the host: one CUDA graph serves every step
    (``launch.serve.DecodeRunner``)."""
    return forward(params, batch, cfg, mode="decode", cache=cache,
                   cache_index=cache_index)


def index_tensor(cache_index, device) -> torch.Tensor:
    """A decode step's position as a 0-d integer tensor on ``device`` (the
    reference's traced int32 scalar): a tensor as it is, an int as an
    int32 tensor made by a fill (no copy from the host)."""
    if torch.is_tensor(cache_index):
        return cache_index
    return torch.full((), cache_index, dtype=torch.int32, device=device)


def cache_device(cache) -> torch.device:
    """The device of a cache tree's first tensor."""
    if torch.is_tensor(cache):
        return cache.device
    for sub in (cache.values() if isinstance(cache, dict) else cache):
        if sub is not None:
            return cache_device(sub)
    raise ValueError("a decode cache holds no tensor")


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _attn_cache(cfg: ModelConfig, B: int, max_len: int, dtype, device,
                stack=()):
    hd = cfg.resolved_head_dim
    length = max_len
    cache = {}
    if cfg.sliding_window is not None and max_len > cfg.sliding_window:
        length = cfg.sliding_window  # ring buffer: slots hold absolute positions
        cache["pos"] = torch.full(stack + (length,), -1, dtype=torch.int32,
                                  device=device)
    shape = stack + (B, length, cfg.num_kv_heads, hd)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _ssm_cache(cfg: ModelConfig, B: int, dtype, device, stack=()):
    d_inner, H, P, N = ssm.dims(cfg)
    conv_dim = d_inner + 2 * N
    return {
        "conv": torch.zeros(stack + (B, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros(stack + (B, H, P, N), dtype=torch.float32,
                             device=device),
    }


def _mlstm_cache(cfg: ModelConfig, B: int, device, stack=()):
    d_inner, H, dk, dv = xlstm.mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(stack + (B, H, dk, dv), **f32),
            "n": torch.zeros(stack + (B, H, dk), **f32),
            "m": torch.full(stack + (B, H), -1e30, **f32)}


def _slstm_cache(cfg: ModelConfig, B: int, device, stack=()):
    H = cfg.num_heads
    P = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(stack + (B, H, P), **f32),
            "n": torch.zeros(stack + (B, H, P), **f32),
            "m": torch.full(stack + (B, H), -1e30, **f32),
            "h": torch.zeros(stack + (B, H, P), **f32)}


def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda"):
    """The decode cache, the reference's layout. Dense/vlm: stacked [L, B,
    max_len, Hkv, hd] k and v, or [L, B, window, Hkv, hd] ring buffers with
    their [L, window] positions when a sliding window is shorter than
    max_len. MoE: {"dense": the leading dense blocks' [n_dense, ...] or
    None, "moe": [L - n_dense, ...]}. Hybrid: {"mamba": conv [n_super, k,
    B, W-1, D] and float32 state [n_super, k, B, H, P, N], "attn": the
    shared block's k/v per application [n_super, ...], "mamba_rem": the
    trailing layers' [n_rem, ...], or None}. xLSTM: {"mlstm": float32 C,
    n, m [n_super, r-1, B, ...], "slstm": c, n, m, h [n_super, B, ...],
    "mlstm_rem": [n_rem, B, ...]}, each None where the model has no such
    blocks, m at -1e30. Encoder-decoder: {"enc_out": [B, encoder_seq_len,
    d], "self": [L, B, max_len, Hkv, hd] k and v}."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.compute_dtype)
    module = _module(cfg)
    if module is transformer:
        return _attn_cache(cfg, B, max_len, dtype, dev, stack=(cfg.num_layers,))
    if module is moe_transformer:
        n_dense = cfg.first_dense_layers
        return {
            "dense": (_attn_cache(cfg, B, max_len, dtype, dev, stack=(n_dense,))
                      if n_dense else None),
            "moe": _attn_cache(cfg, B, max_len, dtype, dev,
                               stack=(cfg.num_layers - n_dense,)),
        }
    if module is hybrid:
        k, n_super, n_rem = hybrid.split_layers(cfg)
        return {
            "mamba": _ssm_cache(cfg, B, dtype, dev, stack=(n_super, k)),
            "attn": _attn_cache(cfg, B, max_len, dtype, dev, stack=(n_super,)),
            "mamba_rem": (_ssm_cache(cfg, B, dtype, dev, stack=(n_rem,))
                          if n_rem else None),
        }
    if module is xlstm_model:
        r, n_super, n_rem = xlstm_model.split_layers(cfg)
        c = {"mlstm": None, "slstm": None, "mlstm_rem": None}
        if n_super:
            c["mlstm"] = _mlstm_cache(cfg, B, dev, stack=(n_super, r - 1))
            c["slstm"] = _slstm_cache(cfg, B, dev, stack=(n_super,))
        if n_rem:
            c["mlstm_rem"] = _mlstm_cache(cfg, B, dev, stack=(n_rem,))
        return c
    if module is encdec:
        return {
            "enc_out": torch.zeros((B, cfg.encoder_seq_len, cfg.d_model),
                                   dtype=dtype, device=dev),
            "self": _attn_cache(cfg, B, max_len, dtype, dev,
                                stack=(cfg.num_layers,)),
        }
    raise ValueError(f"{cfg.name} is a classifier: it has no cache")
