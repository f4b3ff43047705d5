"""The Gaussian-mechanism calibration the static path needs — a copy of
part of the reference's ``repro.core.accounting``: the exact analytic
Gaussian mechanism (Balle & Wang 2018) and ``noise_multiplier``, which
routes epsilon > 1 through it because the classic sqrt(2 ln(1.25/delta))
constant certifies only epsilon <= 1. The RDP ledger is ported later
(ROADMAP A6)."""
from __future__ import annotations

import math

CLASSIC_EPS_MAX = 1.0


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
