"""Differential privacy of the static DWFL round (Sec. IV-A) — part of the
reference's ``repro.core.privacy``: Theorem 4.1's per-receiver budget and
Remark 4.1's O(1/sqrt(N - 1)) bound on it, the orthogonal scheme's
per-link budget, sigma calibration for a target epsilon (DWFL's and the
orthogonal scheme's), and the per-worker gradient clip."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import accounting
from repro_torch.core.channel import ChannelState
from repro_torch.core.exchange import tree_flatten, tree_unflatten


def l2_sensitivity(gamma: float, g_max: float, chan: ChannelState) -> float:
    """Changing one worker's data moves the aggregate by at most
    2 c gamma g_max."""
    return 2.0 * gamma * g_max * chan.c


def epsilon_dwfl(gamma: float, g_max: float, chan: ChannelState,
                 delta: float) -> np.ndarray:
    """Theorem 4.1, Eqt. (11): per-receiver budget epsilon_i."""
    num = 2.0 * gamma * g_max * chan.c
    den = chan.aggregate_noise_std
    return num / den * math.sqrt(2.0 * math.log(1.25 / delta))


def epsilon_dwfl_bound(gamma: float, g_max: float, chan: ChannelState,
                       delta: float) -> np.ndarray:
    """Remark 4.1 upper bound on epsilon_i: the explicit O(1/sqrt(N - 1))
    form, masking noise of the weakest other worker only."""
    N = chan.n_workers
    s2 = (chan.noise_scale ** 2) * chan.cfg.sigma ** 2
    min_others = np.array([np.delete(s2, i).min() for i in range(N)])
    num = 2.0 * gamma * g_max * chan.c
    den = np.sqrt(min_others * 1.0 + chan.cfg.sigma_m ** 2)
    return (num / den / math.sqrt(N - 1)
            * math.sqrt(2.0 * math.log(1.25 / delta)))


def epsilon_orthogonal(gamma: float, g_max: float, chan: ChannelState,
                       delta: float) -> np.ndarray:
    """Remark 4.1: per-link budget of the orthogonal (pairwise) scheme,
    masked by the sender's own noise only."""
    num = 2.0 * gamma * g_max * np.sqrt(chan.h ** 2 * chan.P)
    den = np.sqrt((chan.noise_scale ** 2) * chan.cfg.sigma ** 2 + chan.cfg.sigma_m ** 2)
    return num / den * math.sqrt(2.0 * math.log(1.25 / delta))


def sigma_for_epsilon(epsilon: float, gamma: float, g_max: float,
                      chan: ChannelState, delta: float) -> float:
    """The DP noise std sigma that makes the WORST receiver's budget
    equal epsilon (Eqt. 11 solved for sigma)."""
    agg_req = (2.0 * gamma * g_max * chan.c
               * accounting.noise_multiplier(epsilon, delta))
    s2 = chan.noise_scale ** 2
    min_sum = (s2.sum() - s2).min()
    need = agg_req ** 2 - chan.cfg.sigma_m ** 2
    if need <= 0:
        return 0.0  # channel noise alone already provides epsilon
    return math.sqrt(need / min_sum)


def sigma_for_epsilon_orthogonal(epsilon: float, gamma: float, g_max: float,
                                 chan: ChannelState, delta: float) -> float:
    """The sigma that makes the WORST per-link budget of the orthogonal
    scheme (Remark 4.1) equal epsilon: each link is masked by one sender's
    noise only, so the same epsilon needs far more noise than DWFL's."""
    nm2 = accounting.noise_multiplier(epsilon, delta) ** 2
    num2 = (2.0 * gamma * g_max) ** 2 * (chan.h ** 2 * chan.P) * nm2   # [N]
    s2 = chan.noise_scale ** 2                                         # [N]
    need = (num2 - chan.cfg.sigma_m ** 2) / s2
    worst = float(np.max(need))
    if worst <= 0:
        return 0.0  # per-link AWGN alone already provides epsilon
    return math.sqrt(worst)


def clip_gradient_tree(grads, g_max: float):
    """L2-clip each worker's gradient to norm <= g_max. ``grads`` is the
    flat [N, d] buffer or a worker-stacked tree of [N, ...] leaves; a
    worker's norm runs over all its leaves. A worker whose norm is not
    finite (an overflowed backward pass) gets a zero gradient, and so does
    any non-finite entry. Returns (clipped, norms [N]) with ``clipped`` in
    the form and dtypes of ``grads``, the norm 0 where it was not
    finite."""
    leaves, structure = tree_flatten(grads)
    norm = torch.sqrt(sum(torch.sum(g.float().reshape(g.shape[0], -1) ** 2,
                                    dim=1) for g in leaves))
    finite = torch.isfinite(norm)
    scale = torch.where(finite,
                        torch.clamp_max(g_max / torch.clamp_min(norm, 1e-12), 1.0),
                        torch.zeros_like(norm))

    def one(g):
        col = (g.shape[0],) + (1,) * (g.ndim - 1)
        keep = finite.reshape(col) & torch.isfinite(g)
        return torch.where(keep, g * scale.reshape(col),
                           torch.zeros_like(g)).to(g.dtype)

    return (tree_unflatten(structure, [one(g) for g in leaves]),
            torch.where(finite, norm, torch.zeros_like(norm)))
