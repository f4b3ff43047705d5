"""Model dispatcher, MLP branch (the reference's ``repro.models.model``):
``init_params``, ``forward``, ``cross_entropy`` and ``loss_fn``. Losses
reduce over the batch axis only, so worker-stacked parameters give one
loss per worker."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mlp


def _module(cfg: ModelConfig):
    if cfg.family == "mlp":
        return mlp
    raise NotImplementedError(f"model family {cfg.family!r} is not ported "
                              f"yet (ROADMAP A15)")


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    return _module(cfg).init(generator, cfg, device=device)


def forward(params, batch, cfg: ModelConfig):
    """(logits, cache) of the model family."""
    return _module(cfg).forward(params, batch, cfg)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch (second-to-last) axis of -log softmax at the
    label: [..., B, C], [..., B] -> [...]."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    label_logit = torch.gather(logits.float(), -1,
                               labels.long().unsqueeze(-1)).squeeze(-1)
    return -(label_logit - lse).mean(dim=-1)


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Training loss: cross-entropy of the classifier."""
    logits, _ = forward(params, batch, cfg)
    return cross_entropy(logits, batch["y"])
