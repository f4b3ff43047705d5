"""Mixing plans and the flat parameter buffer — part of the reference's
``repro.core.exchange``.

Every exchange of the mixing family is the one receiver-side update

    x_i <- x_i + eta * listen_i * [ sum_k W_ik (x_k + n_k / c) + m_scale_i * m_i
                                    - x_i - self_i * n_i / c ]

and a ``MixPlan`` carries its W and per-receiver vectors to the fused
round (``repro_torch.kernels.dp_mix.ops.dp_mix_round_plan``). Plans here:
the paper's complete graph (``plan_complete``) and noiseless gossip
(``plan_gossip``). ``FlatSpec`` ravels a parameter tree into the
persistent [N, d] float32 buffer in the reference's order (jax's
``tree_flatten``: dict keys sorted, so each layer is b then w).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.runtime import resolve_device


def mix_noise_amp(chan, device="cuda") -> torch.Tensor:
    """Per-worker DP-noise amplitude |h_k| sqrt(beta_k P_k) sigma, [N]."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(chan.noise_scale), dtype=torch.float32,
                            device=dev)
            * torch.tensor(chan.dp_sigma, dtype=torch.float32, device=dev))


def complete_W(N: int, device="cuda") -> torch.Tensor:
    """The paper's W = (ones - I) / (N - 1)."""
    dev = resolve_device(device)
    return (torch.ones((N, N), device=dev)
            - torch.eye(N, device=dev)) / (N - 1)


@dataclass(frozen=True)
class MixPlan:
    """Everything the fused round needs beyond (params, grads)."""
    W: torch.Tensor                          # [N, N]
    c: torch.Tensor                          # alignment constant
    amp: torch.Tensor                        # [N] DP-noise amplitude
    sigma_m: torch.Tensor                    # receiver AWGN std
    self_scale: Optional[torch.Tensor] = None
    m_scale: Optional[torch.Tensor] = None
    listen: Optional[torch.Tensor] = None
    noisy: bool = True


def plan_complete(proto, chan, device="cuda") -> MixPlan:
    dev = resolve_device(device)
    N = chan.n_workers
    c = torch.tensor(chan.c, dtype=torch.float32, device=dev)
    return MixPlan(W=complete_W(N, dev), c=c, amp=mix_noise_amp(chan, dev),
                   sigma_m=torch.tensor(chan.awgn_sigma, dtype=torch.float32,
                                        device=dev),
                   m_scale=torch.full((N,), 1.0, device=dev)
                   / float(chan.c * (N - 1)))


def plan_gossip(proto, chan, device="cuda") -> MixPlan:
    dev = resolve_device(device)
    N = chan.n_workers
    return MixPlan(W=complete_W(N, dev),
                   c=torch.tensor(chan.c, dtype=torch.float32, device=dev),
                   amp=torch.zeros((N,), device=dev),
                   sigma_m=torch.zeros((), device=dev),
                   m_scale=torch.zeros((N,), device=dev), noisy=False)


# ---------------------------------------------------------------------------
# parameter trees (nested dicts and lists of tensors)
# ---------------------------------------------------------------------------


def tree_flatten(tree):
    """(leaves, structure) in jax's order: dict keys sorted."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(t) for t in tree]
        return ([l for ls, _ in parts for l in ls],
                (type(tree).__name__, None, [s for _, s in parts]))
    return [tree], None


def tree_unflatten(structure, leaves: List[Any]):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        children = [build(c) for c in subs]
        if kind == "dict":
            return dict(zip(keys, children))
        return children if kind == "list" else tuple(children)

    return build(structure)


class FlatSpec:
    """Flatten/unravel contract of the unsharded flat buffer.

    Built from a template tree (only shapes and dtypes are read) with
    ``lead_axes`` leading batch axes (1: worker-stacked [N, ...] leaves).
    ``flatten(X)`` -> [lead..., d] float32; ``unravel(flat)`` -> the
    worker-stacked tree as views of ``flat`` (autograd flows through
    them); ``unravel_row(v)`` -> one worker's tree from a [d] row.
    """

    def __init__(self, template, lead_axes: int = 1):
        leaves, self._structure = tree_flatten(template)
        self._shapes = [tuple(l.shape) for l in leaves]
        self._dtypes = [l.dtype for l in leaves]
        self._sizes = [int(np.prod(s[lead_axes:])) for s in self._shapes]
        self.lead_axes = int(lead_axes)
        self.d = int(sum(self._sizes))

    def flatten(self, X) -> torch.Tensor:
        leaves, _ = tree_flatten(X)
        return torch.cat(
            [l.reshape(l.shape[:self.lead_axes] + (-1,)).float()
             for l in leaves], dim=-1)

    def _split(self, flat, lead):
        out, off = [], 0
        for s, dt, n in zip(self._shapes, self._dtypes, self._sizes):
            out.append(flat[..., off:off + n]
                       .reshape(lead + s[self.lead_axes:]).to(dt))
            off += n
        return tree_unflatten(self._structure, out)

    def unravel(self, flat):
        return self._split(flat, tuple(flat.shape[:-1]))

    def unravel_row(self, v):
        return self._split(v, ())
