"""Differential privacy of the static DWFL round (Sec. IV-A) — part of the
reference's ``repro.core.privacy``: Theorem 4.1's per-receiver budget, the
orthogonal scheme's per-link budget (Remark 4.1), sigma calibration for a
target epsilon, and the per-worker gradient clip."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import accounting
from repro_torch.core.channel import ChannelState


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


def clip_gradient_tree(grads: torch.Tensor, g_max: float):
    """L2-clip each row of the per-worker gradients [N, d] to norm <= g_max.
    A row whose norm is not finite (an overflowed backward pass) is zeroed,
    and so is any non-finite entry. Returns (clipped [N, d], norms [N]),
    the norm 0 where it was not finite."""
    norm = torch.sqrt(torch.sum(grads.float() ** 2, dim=-1))
    finite = torch.isfinite(norm)
    scale = torch.where(finite,
                        torch.clamp_max(g_max / torch.clamp_min(norm, 1e-12), 1.0),
                        torch.zeros_like(norm))
    keep = finite[:, None] & torch.isfinite(grads)
    clipped = torch.where(keep, grads * scale[:, None], torch.zeros_like(grads))
    return clipped.to(grads.dtype), torch.where(finite, norm, torch.zeros_like(norm))
