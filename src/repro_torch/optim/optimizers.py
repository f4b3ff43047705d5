"""Optimizers, the reference's ``repro.optim.optimizers``: (init, update)
pairs over parameter trees (nested dicts and lists of tensors). DWFL
itself embeds plain SGD (Alg. 1 line 5); momentum and Adam serve the
centralized baseline and experiments beyond the paper. The arithmetic is
float32 and each new parameter keeps its parameter's dtype, as in the
reference."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.exchange import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        new = tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                       params, grads)
        return new, state
    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(_zeros, params)

    def update(grads, state, params):
        v = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        new = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                       params, v)
        return new, v
    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = tree_map(_zeros, params)
        return {"m": z, "v": tree_map(torch.zeros_like, z), "t": 0}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        # the bias corrections as float32 scalars, as the reference
        # computes them from its step count
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = 1 - f32(b1) ** f32(t)
        bc2 = 1 - f32(b2) ** f32(t)
        new = tree_map(
            lambda p, m_, v_: (p.float() - lr * (m_ / bc1)
                               / (torch.sqrt(v_ / bc2) + eps)).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}
    return Optimizer(init, update)
