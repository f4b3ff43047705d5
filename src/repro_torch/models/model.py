"""Model dispatcher (the reference's ``repro.models.model``): one API over
the ported families.

    params          = init_params(generator, cfg, device)
    loss            = loss_fn(params, batch, cfg)
    logits, cache   = prefill(params, batch, cfg, use_pallas=False)
    logits, cache   = decode_step(params, batch, cache, idx, cfg)
    cache           = init_cache(cfg, batch_size, max_len, device)

Ported: the MLP classifier (family "mlp"), the dense transformer
(families "dense" and "vlm") and the Mamba2 + shared-attention hybrid
(family "hybrid", zamba2). The other families raise, naming the ROADMAP
item that ports them. Batches are dicts: "x"/"y" for the
classifier, "tokens" [B, S] or "embeds" [B, S, d] for the LMs.
The classifier's losses reduce over the batch axis only, so
worker-stacked parameters give one loss per worker.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, mlp, ssm, transformer
from repro_torch.runtime import resolve_device

_NOT_PORTED = {"moe": "A15 (moe)", "ssm": "A15 (ssm / xlstm)",
               "audio": "A15 (encdec)"}


def _module(cfg: ModelConfig):
    if cfg.family == "mlp":
        return mlp
    if cfg.family in ("dense", "vlm"):
        return transformer
    if cfg.family == "hybrid":
        return hybrid
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet "
        f"(ROADMAP {_NOT_PORTED.get(cfg.family, 'A15')})")


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    return _module(cfg).init(generator, cfg, device=resolve_device(device))


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, use_pallas: bool = False):
    """(logits, cache) of the model family."""
    if cfg.family == "mlp":
        return mlp.forward(params, batch, cfg)
    return _module(cfg).forward(params, batch, cfg, mode=mode, cache=cache,
                                cache_index=cache_index, use_pallas=use_pallas)


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
    cross-entropy of an LM."""
    if cfg.family == "mlp":
        logits, _ = mlp.forward(params, batch, cfg)
        return cross_entropy(logits, batch["y"])
    logits, _ = forward(params, batch, cfg, mode="train", use_pallas=use_pallas)
    if "labels" in batch:
        return lm_cross_entropy(logits, batch["labels"])
    return lm_cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])


def prefill(params, batch, cfg: ModelConfig, use_pallas: bool = False):
    return forward(params, batch, cfg, mode="prefill", use_pallas=use_pallas)


def decode_step(params, batch, cache, cache_index, cfg: ModelConfig):
    return forward(params, batch, cfg, mode="decode", cache=cache,
                   cache_index=cache_index)


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


def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda"):
    """The decode cache. Dense/vlm: stacked [L, B, max_len, Hkv, hd] k and
    v, or [L, B, window, Hkv, hd] ring buffers with their [L, window]
    positions when a sliding window is shorter than max_len. Hybrid:
    {"mamba": conv [n_super, k, B, W-1, D] and float32 state [n_super, k,
    B, H, P, N], "attn": the shared block's k/v per application [n_super,
    ...], "mamba_rem": the trailing layers' [n_rem, ...], or None}."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.compute_dtype)
    module = _module(cfg)
    if module is hybrid:
        k, n_super, n_rem = hybrid.split_layers(cfg)
        return {
            "mamba": _ssm_cache(cfg, B, dtype, dev, stack=(n_super, k)),
            "attn": _attn_cache(cfg, B, max_len, dtype, dev, stack=(n_super,)),
            "mamba_rem": (_ssm_cache(cfg, B, dtype, dev, stack=(n_rem,))
                          if n_rem else None),
        }
    if module is not transformer:
        raise ValueError(f"{cfg.name} is a classifier: it has no cache")
    return _attn_cache(cfg, B, max_len, dtype, dev, stack=(cfg.num_layers,))
