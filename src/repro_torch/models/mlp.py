"""The paper-scale MLP classifier (the reference's ``repro.models.mlp``).

Parameters are the reference's tree {"layers": [{"w": [in, out],
"b": [out]}, ...]}; ``forward`` also takes worker-stacked parameters
(leaves [N, ...]) with a batch [N, B, in] and runs every worker's forward
at once through batched matrix products. batch: {"x": [..., B, in],
"y": [..., B]}; the number of classes is ``cfg.vocab_size``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig

INPUT_DIM = 3072


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype, device) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(in_dim) (layers.dense_init)."""
    w = torch.randn((in_dim, out_dim), generator=generator, device=device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def init(generator: torch.Generator, cfg: ModelConfig,
         input_dim: int = INPUT_DIM, device="cuda"):
    dtype = getattr(torch, cfg.param_dtype)
    dims = [input_dim] + [cfg.d_model] * cfg.num_layers + [cfg.vocab_size]
    return {"layers": [
        {"w": dense_init(generator, dims[i], dims[i + 1], dtype, device),
         "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
        for i in range(len(dims) - 1)]}


def forward(params, batch, cfg: ModelConfig):
    x = batch["x"].to(getattr(torch, cfg.compute_dtype))
    n = len(params["layers"])
    for i, lyr in enumerate(params["layers"]):
        x = torch.matmul(x, lyr["w"]) + lyr["b"].unsqueeze(-2)
        if i < n - 1:
            x = torch.relu(x)
    return x, None
