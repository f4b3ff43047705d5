"""Block fading with the power alignment redone on the device — the port
of the reference's ``repro.net.fading``.

Each worker's small-scale gain is complex, stored as [N, 2] (re, im);
only |g| reaches the protocol (the sender cancels the phase, Eqt. 2):

  * Rayleigh:  g ~ CN(0, 1);
  * Rician(K): g = sqrt(K/(K+1)) + sqrt(1/(K+1)) CN(0, 1), the line of
    sight on the real axis;
  * unit:      |g| = 1.

Across coherence blocks the diffuse part follows AR(1), d' = rho d +
sqrt(1 - rho^2) w, rho given or from a Doppler frequency by Jakes' model,
rho = J0(2 pi f_D tau) (``rho_from_doppler``). ``advance`` redraws it at
block edges (t = 0 mod coherence_rounds) and holds it inside a block; the
round counter t lives on the device, so a round never asks the host.
Each new channel is re-aligned on the device (``align``, Eqt. 3-4 with
the static channel's 5% noise-power floor).

The draws come from the caller's ``torch.Generator``, in a fixed order;
they are the port's own, checked in distribution, not the reference's
``jax.random`` streams.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.net.state import TracedChannelState

H_FLOOR = 0.05        # keeps the worst SNR away from 0 (as core.channel)
POWER_FLOOR = 0.05    # power reserved for noise before aligning


def bessel_j0(x) -> np.ndarray:
    """J0 by the Abramowitz & Stegun 9.4.1 / 9.4.3 fits (|err| < 2e-8),
    on the host."""
    x = np.abs(np.asarray(x, np.float64))
    small = x <= 3.0
    t = (x / 3.0) ** 2
    p_small = (1.0 - 2.2499997 * t + 1.2656208 * t ** 2 - 0.3163866 * t ** 3
               + 0.0444479 * t ** 4 - 0.0039444 * t ** 5 + 0.0002100 * t ** 6)
    xs = np.where(small, 3.0, x)   # no division by zero on the unused branch
    u = 3.0 / xs
    f0 = (0.79788456 - 0.00000077 * u - 0.00552740 * u ** 2
          - 0.00009512 * u ** 3 + 0.00137237 * u ** 4 - 0.00072805 * u ** 5
          + 0.00014476 * u ** 6)
    th0 = (xs - 0.78539816 - 0.04166397 * u - 0.00003954 * u ** 2
           + 0.00262573 * u ** 3 - 0.00054125 * u ** 4 - 0.00029333 * u ** 5
           + 0.00013558 * u ** 6)
    p_large = f0 * np.cos(th0) / np.sqrt(xs)
    return np.where(small, p_small, p_large)


def rho_from_doppler(doppler_hz: float, block_seconds: float) -> float:
    """Jakes: the gain's correlation across one block, J0(2 pi f_D tau),
    clamped to [0, 1) (J0's negative lobes count as decorrelated)."""
    rho = float(bessel_j0(2.0 * math.pi * doppler_hz * block_seconds))
    return min(max(rho, 0.0), 1.0 - 1e-9)


@dataclass(frozen=True)
class FadingConfig:
    kind: str = "rayleigh"      # rayleigh | rician | unit
    rician_k: float = 0.0       # K-factor (linear LOS / diffuse power)
    rho: float = 0.0            # AR(1) correlation across blocks
    coherence_rounds: int = 1   # DWFL rounds per fading block (>= 1)
    h_floor: float = H_FLOOR

    @property
    def los(self) -> float:
        if self.kind == "rician":
            return math.sqrt(self.rician_k / (self.rician_k + 1.0))
        return 0.0

    @property
    def diffuse_std(self) -> float:
        """Per-component std of the diffuse part: CN(0, s^2) with s^2 =
        1/(K+1) (Rician) or 1 (Rayleigh)."""
        if self.kind == "rician":
            return math.sqrt(1.0 / (self.rician_k + 1.0) / 2.0)
        return math.sqrt(0.5)


@dataclass(frozen=True)
class FadingState:
    diffuse: torch.Tensor   # [N, 2] diffuse complex gains
    t: torch.Tensor         # int32 round counter


def init_fading(cfg: FadingConfig, generator: torch.Generator,
                n_workers: int) -> FadingState:
    dev = generator.device
    if cfg.kind == "unit":
        diffuse = torch.zeros((n_workers, 2), device=dev)
    else:
        diffuse = cfg.diffuse_std * torch.randn(
            (n_workers, 2), generator=generator, device=dev)
    return FadingState(diffuse=diffuse,
                       t=torch.zeros((), dtype=torch.int32, device=dev))


def magnitudes(cfg: FadingConfig, state: FadingState) -> torch.Tensor:
    """|h_k| = |LOS + diffuse_k|, floored."""
    d = state.diffuse
    if cfg.kind == "unit":
        return torch.ones((d.shape[0],), device=d.device)
    re, im = d[:, 0] + cfg.los, d[:, 1]
    return torch.clamp_min(torch.sqrt(re * re + im * im), cfg.h_floor)


def advance(cfg: FadingConfig, generator: torch.Generator,
            state: FadingState) -> FadingState:
    """One round of the block clock: the AR(1) step at block edges, the
    same gains inside a block. The innovation is drawn every round, so
    the generator's stream does not depend on where the blocks fall."""
    t_next = state.t + 1
    if cfg.kind == "unit":
        return FadingState(diffuse=state.diffuse, t=t_next)
    w = cfg.diffuse_std * torch.randn(state.diffuse.shape,
                                      generator=generator,
                                      device=state.diffuse.device)
    rho = np.float32(cfg.rho)
    stepped = float(rho) * state.diffuse + float(
        np.sqrt(np.float32(1.0) - rho * rho)) * w
    redraw = torch.remainder(t_next, cfg.coherence_rounds) == 0
    return FadingState(diffuse=torch.where(redraw, stepped, state.diffuse),
                       t=t_next)


def align(h: torch.Tensor, P: torch.Tensor, *, noise_policy: str = "surplus",
          beta_slack: float = 1.0, power_floor: float = POWER_FLOOR):
    """The paper's power alignment (Eqt. 3-4) on the device, as
    ChannelConfig.realize does it once: (alpha, beta, c) with
    |h_i| sqrt(alpha_i P_i) = c for every worker."""
    eff = h * h * P
    eff_min = torch.amin(eff, dim=-1, keepdim=True)
    alpha = (1.0 - power_floor) * eff_min / eff        # Eqt. (3), derated
    c = torch.sqrt((1.0 - power_floor) * eff_min).squeeze(-1)   # Eqt. (4)
    if noise_policy == "equal":
        beta = torch.minimum(1.0 - alpha, c.unsqueeze(-1) ** 2 / eff)
    elif noise_policy == "surplus":
        beta = beta_slack * (1.0 - alpha)
    else:
        raise ValueError(noise_policy)
    return alpha, beta, c


def channel_state(cfg: FadingConfig, state: FadingState, P: float,
                  sigma: float, sigma_m: float, *, path_gain=None,
                  noise_policy: str = "surplus",
                  beta_slack: float = 1.0) -> TracedChannelState:
    """The round's channel: small-scale magnitudes times the amplitude of
    the large-scale power gain, then re-aligned; every worker transmits at
    P watts."""
    h = magnitudes(cfg, state)
    if path_gain is not None:
        h = torch.clamp_min(h * torch.sqrt(path_gain), cfg.h_floor)
    P = torch.full_like(h, P)
    alpha, beta, c = align(h, P, noise_policy=noise_policy,
                           beta_slack=beta_slack)
    full = lambda v: torch.full((), v, device=h.device)
    return TracedChannelState(h=h, P=P, alpha=alpha, beta=beta, c=c,
                              sigma=full(sigma), sigma_m=full(sigma_m),
                              n_workers=int(h.shape[0]))
