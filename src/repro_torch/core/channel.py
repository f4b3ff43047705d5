"""Gaussian multiple-access channel of the paper (Sec. III) — a numpy copy
of the reference's ``repro.core.channel``.

Per-worker channel gains |h_k|, transmit powers P_k, the power-alignment
rule (Eqt. 3-4) on a budget derated by a 5% noise floor,

    alpha_i = 0.95 min_j |h_j|^2 P_j / (|h_i|^2 P_i),
    c = sqrt(0.95 min_j |h_j|^2 P_j),

and AWGN of std sigma_m at each receiver.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


def dbm_to_watts(p_dbm) -> np.ndarray:
    return 10.0 ** ((np.asarray(p_dbm, np.float64) - 30.0) / 10.0)


@dataclass(frozen=True)
class ChannelConfig:
    n_workers: int
    p_dbm: float = 60.0            # per-worker max transmit power
    sigma: float = 1.0             # DP Gaussian noise std
    sigma_m: float = 1.0           # channel AWGN std
    fading: str = "rayleigh"       # "rayleigh" | "unit"
    seed: int = 0
    beta_slack: float = 1.0        # beta_i = beta_slack * (1 - alpha_i)
    noise_policy: str = "surplus"  # "surplus" (the paper) | "equal"

    def realize(self) -> "ChannelState":
        rng = np.random.default_rng(self.seed)
        N = self.n_workers
        if self.fading == "rayleigh":
            h = rng.rayleigh(scale=1.0 / np.sqrt(2.0), size=N)
            h = np.maximum(h, 0.05)  # keep the worst SNR bounded away from 0
        elif self.fading == "unit":
            h = np.ones(N)
        else:
            raise ValueError(self.fading)
        P = np.full(N, float(dbm_to_watts(self.p_dbm)))
        eff = h * h * P
        # a 5% power floor reserved for noise BEFORE aligning, so every
        # worker injects some noise and the alignment stays exact
        floor = 0.05
        alpha = (1.0 - floor) * eff.min() / eff          # Eqt. (3), derated
        c = float(np.sqrt((1.0 - floor) * eff.min()))    # Eqt. (4), derated
        if self.noise_policy == "equal":
            beta = np.minimum(1.0 - alpha, c ** 2 / eff)
        else:  # "surplus" — the paper's policy
            beta = self.beta_slack * (1.0 - alpha)
        return ChannelState(cfg=self, h=h, P=P, alpha=alpha, beta=beta, c=c)


@dataclass(frozen=True)
class ChannelState:
    """Realized, time-invariant channel (the one-shot calibration)."""
    cfg: ChannelConfig
    h: np.ndarray        # [N] |h_k|
    P: np.ndarray        # [N] watts
    alpha: np.ndarray    # [N] power fraction for the parameter signal
    beta: np.ndarray     # [N] power fraction for the DP noise
    c: float             # alignment constant

    @property
    def n_workers(self) -> int:
        return self.cfg.n_workers

    @property
    def dp_sigma(self) -> float:
        return self.cfg.sigma

    @property
    def awgn_sigma(self) -> float:
        return self.cfg.sigma_m

    @property
    def signal_scale(self) -> np.ndarray:
        """|h_k| sqrt(alpha_k P_k) — equals c for every worker."""
        return self.h * np.sqrt(self.alpha * self.P)

    @property
    def noise_scale(self) -> np.ndarray:
        """|h_k| sqrt(beta_k P_k): per-worker DP-noise amplitude."""
        return self.h * np.sqrt(self.beta * self.P)

    @property
    def aggregate_noise_std(self) -> np.ndarray:
        """Per receiver i: sqrt(sum_{k != i} |h_k|^2 beta_k P_k sigma^2 + sigma_m^2)."""
        s2 = (self.noise_scale ** 2) * self.cfg.sigma ** 2
        tot = s2.sum() - s2
        return np.sqrt(tot + self.cfg.sigma_m ** 2)

    def with_sigma(self, sigma: float) -> "ChannelState":
        return dataclasses.replace(self, cfg=dataclasses.replace(self.cfg, sigma=sigma))
