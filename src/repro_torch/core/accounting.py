"""Renyi-DP (moments) accounting for the DWFL Gaussian mechanism — a copy
of the reference's ``repro.core.accounting``.

Every round of the over-the-air exchange is a Gaussian mechanism of
sensitivity Delta = 2 gamma g_max c masked by the receiver's aggregate
noise power agg^2 = sum_{k in N(i)} s_k^2 sigma^2 + sigma_m^2. Its Renyi
divergence is eps(alpha) = alpha rho with rho = Delta^2 / (2 agg^2) at
every order, RDP composes additively over rounds, and the Canonne-Kamath-
Steinke conversion

    eps(delta) = min_alpha [ eps_rdp(alpha) + log((alpha - 1)/alpha)
                             - (log delta + log alpha)/(alpha - 1) ]

turns the ledger into a final budget far tighter than advanced
composition at the same delta. Advanced composition spends a total delta
as delta/(2T) a round plus delta/2 of slack (``split_delta``); the RDP
ledger spends all of it in the conversion.

Also here: the exact analytic Gaussian mechanism (Balle & Wang 2018) and
``noise_multiplier``, which routes epsilon > 1 through it because the
classic sqrt(2 ln(1.25/delta)) constant certifies only epsilon <= 1.

Host math is float64 numpy. ``rdp_dwfl_traced`` and
``sigma_for_rho_traced`` take a round's ``net.TracedChannelState`` and W
as tensors on their device and never copy them to the host.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# The fixed RDP order grid: 25 orders over [1.25, 512], dense at the low
# end, geometric above 2.
ORDER_GRID: Tuple[float, ...] = (
    1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0, 8.0, 10.0,
    12.0, 16.0, 20.0, 24.0, 32.0, 48.0, 64.0, 96.0, 128.0, 192.0,
    256.0, 384.0, 512.0)
N_ORDERS = len(ORDER_GRID)

CLASSIC_EPS_MAX = 1.0


def _orders(orders: Optional[Sequence[float]]) -> np.ndarray:
    return np.asarray(ORDER_GRID if orders is None else orders, np.float64)


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def gaussian_delta(sensitivity: float, sigma: float, epsilon: float) -> float:
    """Exact delta(epsilon) of N(0, sigma^2) at sensitivity Delta:
    Phi(D/2s - e s/D) - e^e Phi(-D/2s - e s/D)."""
    if sigma <= 0:
        return 1.0
    a = sensitivity / (2.0 * sigma)
    b = epsilon * sigma / sensitivity
    t2 = 0.5 * math.erfc((a + b) / math.sqrt(2.0))
    t2 = math.exp(epsilon) * t2 if t2 > 0.0 else 0.0
    return max(_phi(a - b) - t2, 0.0)


def gaussian_epsilon(sensitivity: float, sigma: float, delta: float) -> float:
    """The epsilon that N(0, sigma^2) delivers at delta: bisection on
    gaussian_delta, which decreases in epsilon."""
    lo, hi = 0.0, 1.0
    while gaussian_delta(sensitivity, sigma, hi) > delta:
        hi *= 2.0
        if hi > 1e6:
            return hi
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if gaussian_delta(sensitivity, sigma, mid) > delta:
            lo = mid
        else:
            hi = mid
    return hi


def analytic_gaussian_sigma(sensitivity: float, epsilon: float,
                            delta: float) -> float:
    """Smallest sigma with gaussian_delta(Delta, sigma, epsilon) <= delta."""
    if epsilon <= 0:
        raise ValueError(f"epsilon must be > 0, got {epsilon}")
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    hi = (math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity
          / min(epsilon, 1.0))
    lo = 1e-9 * sensitivity
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if gaussian_delta(sensitivity, mid, epsilon) > delta:
            lo = mid
        else:
            hi = mid
    return hi


def noise_multiplier(epsilon: float, delta: float) -> float:
    """sigma / Delta achieving (epsilon, delta)-DP: the classic constant
    for epsilon <= 1, the exact analytic calibration beyond it."""
    if epsilon <= 0:
        raise ValueError(f"epsilon must be > 0, got {epsilon}")
    if epsilon <= CLASSIC_EPS_MAX:
        return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon
    return analytic_gaussian_sigma(1.0, epsilon, delta)


# ---------------------------------------------------------------------------
# per-round RDP
# ---------------------------------------------------------------------------


def rho_from_epsilon(eps, delta: float):
    """Per-round Gaussian RDP rate from the Eqt. (11) budget at per-round
    delta: eps = (Delta/agg) sqrt(2 ln(1.25/delta)) and rho = Delta^2 /
    (2 agg^2), so rho = eps^2 / (4 ln(1.25/delta)). Scalars or arrays."""
    return eps ** 2 / (4.0 * math.log(1.25 / delta))


def rdp_dwfl_traced(gamma: float, g_max: float, chan, W=None,
                    orders: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The worst receiver's per-round RDP vector eps(alpha) [A] on the
    order grid, on the channel's device (W None: the complete graph). A
    receiver that hears nothing contributes rho = 0. A stacked trajectory
    (leaves [T, ...], Ws [T, N, N] or a stacked SparseW) gives [T, A].
    ``orders``: the grid as a float32 tensor on that device, made once by
    a caller in a loop (building it here is a host-to-device copy, which
    waits for the device)."""
    from repro_torch.core.privacy import _masking_sums, _rx
    num = 2.0 * gamma * g_max * _rx(chan.c)
    mask_sum, listening = _masking_sums(chan, W)
    agg2 = mask_sum * _rx(chan.sigma) ** 2 + _rx(chan.sigma_m) ** 2
    rho = torch.where(listening, num ** 2 / (2.0 * agg2), 0.0)
    if orders is None:
        orders = torch.tensor(ORDER_GRID, dtype=torch.float32,
                              device=rho.device)
    return orders * rho.amax(-1, keepdim=True)


def rdp_subsampled_gaussian(rho: float, q: float,
                            orders: Optional[Sequence[float]] = None
                            ) -> np.ndarray:
    """Per-round RDP of the q-subsampled Gaussian mechanism of rate rho
    (Mironov-Talwar-Zhang sampled-Gaussian moments at integer orders, in
    log space); a fractional order takes the value at its ceiling, which
    stays conservative. q = 1 is alpha rho exactly."""
    al = _orders(orders)
    if not (0.0 < q <= 1.0):
        raise ValueError(f"participation rate q must be in (0, 1], got {q}")
    if q == 1.0:
        return al * rho
    out = np.empty_like(al)
    lq, l1q = math.log(q), math.log1p(-q)
    for i, a in enumerate(al):
        n = int(math.ceil(a))
        terms = [math.lgamma(n + 1) - math.lgamma(j + 1)
                 - math.lgamma(n - j + 1) + j * lq + (n - j) * l1q
                 + j * (j - 1) * rho for j in range(n + 1)]
        m = max(terms)
        log_a = m + math.log(sum(math.exp(t - m) for t in terms))
        out[i] = log_a / (n - 1) if n > 1 else log_a
    return out


# ---------------------------------------------------------------------------
# RDP -> (epsilon, delta) and composition
# ---------------------------------------------------------------------------


def rdp_to_epsilon(rdp_total, delta, orders: Optional[Sequence[float]] = None):
    """The CKS conversion of an accumulated [..., A] ledger at ``delta``
    (a scalar or broadcastable to the leading dims). Returns (eps [...],
    best order [...]); an all-zero ledger converts to eps = 0."""
    al = _orders(orders)
    r = np.asarray(rdp_total, np.float64)
    if r.shape[-1] != al.shape[0]:
        raise ValueError(f"rdp last axis must match the order grid "
                         f"({al.shape[0]}), got shape {r.shape}")
    d = np.asarray(delta, np.float64)
    if np.any(d <= 0.0) or np.any(d >= 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    conv = (r + np.log1p(-1.0 / al)
            - (np.log(d)[..., None] + np.log(al)) / (al - 1.0))
    best = np.argmin(conv, axis=-1)
    eps = np.maximum(np.min(conv, axis=-1), 0.0)
    eps = np.where(np.sum(r, axis=-1) > 0.0, eps, 0.0)
    order = al[best]
    if eps.ndim == 0:
        return float(eps), float(order)
    return eps, order


def split_delta(delta_total: float, T: int) -> Tuple[float, float]:
    """Advanced composition against a total delta: delta_round =
    delta/(2T) and delta' = delta/2, so T delta_round + delta' = delta."""
    if not (0.0 < delta_total < 1.0):
        raise ValueError(f"total delta budget must be in (0, 1), "
                         f"got {delta_total}")
    if T < 1:
        raise ValueError(f"composition needs T >= 1 rounds, got {T}")
    d_round = delta_total / (2.0 * T)
    if d_round <= 0.0:
        raise ValueError(f"delta budget {delta_total} infeasible at "
                         f"T={T}: per-round share underflows")
    return d_round, delta_total / 2.0


def rescale_epsilon_delta(eps, delta_from: float, delta_to: float):
    """A Gaussian budget re-quoted at another per-round delta: eps is
    proportional to sqrt(ln(1.25/delta)) at fixed sigma."""
    return eps * math.sqrt(math.log(1.25 / delta_to)
                           / math.log(1.25 / delta_from))


def compose_trajectory(eps_rounds, delta_total: float,
                       delta_ref: Optional[float] = None,
                       orders: Optional[Sequence[float]] = None) -> dict:
    """Both accountants over a realized per-round worst-receiver eps
    trajectory [..., T] (measured at per-round delta ``delta_ref``,
    default delta_total), at the same total delta: advanced composition
    with the delta split, and the RDP ledger converted at delta_total."""
    from repro_torch.core import privacy
    e = np.asarray(eps_rounds, np.float64)
    T = e.shape[-1]
    d_round, d_prime = split_delta(delta_total, T)
    ref = delta_total if delta_ref is None else delta_ref
    e_split = rescale_epsilon_delta(e, ref, d_round)
    eps_adv, _ = privacy.compose_heterogeneous_batched(e_split, d_round,
                                                       d_prime)
    rho = rho_from_epsilon(e, ref)
    rdp_total = np.sum(rho, axis=-1)[..., None] * _orders(orders)
    eps_rdp, order = rdp_to_epsilon(rdp_total, delta_total, orders)
    eps_min = np.minimum(eps_adv, eps_rdp)
    out = {
        "epsilon_advanced": eps_adv,
        "epsilon_rdp": eps_rdp,
        "epsilon": eps_min,
        "rdp_order": order,
        "delta": delta_total,
        "delta_round": d_round,
        "delta_prime": d_prime,
        "gap_ratio": np.where(eps_rdp > 0.0, eps_adv / np.maximum(
            eps_rdp, 1e-300), 1.0),
        "saturated": eps_adv >= privacy.EPS_SATURATION,
    }
    if np.ndim(eps_adv) == 0:
        out = {k: (float(v) if isinstance(v, np.ndarray) and v.ndim == 0
                   else v) for k, v in out.items()}
        out["saturated"] = bool(out["saturated"])
    return out


# ---------------------------------------------------------------------------
# sigma against a T-round total budget
# ---------------------------------------------------------------------------


def rho_total_for_epsilon(eps_total: float, delta: float,
                          orders: Optional[Sequence[float]] = None) -> float:
    """The largest total RDP rate whose converted budget stays within
    (eps_total, delta): bisection on rdp_to_epsilon."""
    if eps_total <= 0:
        raise ValueError(f"epsilon budget must be > 0, got {eps_total}")
    al = _orders(orders)

    def conv(rho: float) -> float:
        return rdp_to_epsilon(rho * al, delta, al)[0]

    lo, hi = 0.0, 1.0
    while conv(hi) < eps_total:
        hi *= 2.0
        if hi > 1e12:
            break
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if conv(mid) < eps_total:
            lo = mid
        else:
            hi = mid
    return lo


def epsilon_round_for_total_advanced(eps_total: float, delta_total: float,
                                     T: int) -> Tuple[float, float]:
    """The largest per-round eps (at its delta_round share) whose T-round
    delta-split advanced composition stays within eps_total. Returns
    (eps_round, delta_round)."""
    from repro_torch.core import privacy
    d_round, d_prime = split_delta(delta_total, T)

    def total(e: float) -> float:
        return privacy.compose_advanced(e, d_round, T, d_prime)[0]

    lo, hi = 0.0, 1.0
    while total(hi) < eps_total:
        hi *= 2.0
        if hi > 1e4:
            break
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if total(mid) < eps_total:
            lo = mid
        else:
            hi = mid
    return lo, d_round


def _worst_masking_sum(chan, W=None) -> float:
    """The smallest masking power sum_{k in N(i)} s_k^2 over listening
    receivers of a static ChannelState (W None: the complete graph)."""
    s2 = np.asarray(chan.noise_scale, np.float64) ** 2
    if W is None:
        return float((s2.sum() - s2).min())
    adj = (np.asarray(W) > 0).astype(np.float64)
    np.fill_diagonal(adj, 0.0)
    mask_sum = adj @ s2
    listening = adj.sum(1) > 0
    if not listening.any():
        raise ValueError("no receiver hears anyone — total-budget "
                         "calibration is undefined on an empty topology")
    return float(mask_sum[listening].min())


def sigma_for_total_epsilon(eps_total: float, gamma: float, g_max: float,
                            chan, delta_total: float, T: int,
                            accountant: str = "rdp", W=None,
                            orders: Optional[Sequence[float]] = None
                            ) -> float:
    """The DP noise std that makes the worst receiver's T-round budget
    (eps_total, delta_total) under ``accountant``: "rdp" inverts the CKS
    conversion and spreads the total rate evenly over T rounds;
    "composition" inverts delta-split advanced composition for the
    per-round eps and its (guarded) constant."""
    if accountant not in ("rdp", "composition"):
        raise ValueError(f"accountant must be 'rdp' or 'composition', "
                         f"got {accountant!r}")
    num = 2.0 * gamma * g_max * float(chan.c)
    sigma_m2 = float(chan.cfg.sigma_m) ** 2
    min_sum = _worst_masking_sum(chan, W)
    if accountant == "rdp":
        rho_round = rho_total_for_epsilon(eps_total, delta_total, orders) / T
        agg2_req = num ** 2 / (2.0 * rho_round)
    else:
        e_round, d_round = epsilon_round_for_total_advanced(
            eps_total, delta_total, T)
        agg2_req = (num * noise_multiplier(e_round, d_round)) ** 2
    need = agg2_req - sigma_m2
    if need <= 0:
        return 0.0  # the receiver AWGN alone meets the budget
    return math.sqrt(need / min_sum)


def sigma_for_rho_traced(rho_round: float, gamma: float, g_max: float, chan,
                         W=None) -> torch.Tensor:
    """The rdp branch of sigma_for_total_epsilon on a round's traced
    channel: solve the worst listening receiver's Delta^2/(2 agg^2) =
    rho_round for sigma on the device (``rho_round`` a host float)."""
    from repro_torch.core.privacy import _masking_sums
    num = 2.0 * gamma * g_max * chan.c
    mask_sum, listening = _masking_sums(chan, W)
    min_sum = torch.where(listening, mask_sum, math.inf).amin(-1)
    min_sum = torch.where(torch.isfinite(min_sum), min_sum, 1.0)
    need = num ** 2 / (2.0 * rho_round) - chan.sigma_m ** 2
    return torch.sqrt(torch.clamp_min(need, 0.0)
                      / torch.clamp_min(min_sum, 1e-30))
