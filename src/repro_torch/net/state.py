"""A round's channel as device tensors — the port of the reference's
``repro.net.state``.

``TracedChannelState`` mirrors ``core.channel.ChannelState`` with tensors
in place of numpy arrays and floats: ``h``, ``P``, ``alpha``, ``beta``
[N], and the scalars ``c``, ``sigma``, ``sigma_m`` as 0-d tensors. A
round's channel is an argument of the dynamic train steps, so one step
serves every realization. It shares the static state's duck-typed
surface (``n_workers``, ``c``, ``noise_scale``, ``signal_scale``,
``aggregate_noise_std``, ``dp_sigma``, ``awgn_sigma``, ``with_sigma``),
which the exchange's plans and the privacy functions read; nothing here
copies to the host. ``stack_states`` stacks rounds along a new leading
axis T for the per-round privacy trajectory. ``telemetry()`` is not
ported yet (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.core.channel import ChannelState
from repro_torch.runtime import resolve_device

FIELDS = ("h", "P", "alpha", "beta", "c", "sigma", "sigma_m")


@dataclass(frozen=True)
class TracedChannelState:
    h: torch.Tensor          # [N] fading magnitudes (path gain folded in)
    P: torch.Tensor          # [N] watts
    alpha: torch.Tensor      # [N] power fraction of the parameter signal
    beta: torch.Tensor       # [N] power fraction of the DP noise
    c: torch.Tensor          # alignment constant
    sigma: torch.Tensor      # DP-noise std
    sigma_m: torch.Tensor    # receiver AWGN std
    n_workers: int

    @property
    def dp_sigma(self) -> torch.Tensor:
        return self.sigma

    @property
    def awgn_sigma(self) -> torch.Tensor:
        return self.sigma_m

    @property
    def signal_scale(self) -> torch.Tensor:
        """|h_k| sqrt(alpha_k P_k): c for every worker after alignment."""
        return self.h * torch.sqrt(self.alpha * self.P)

    @property
    def noise_scale(self) -> torch.Tensor:
        """|h_k| sqrt(beta_k P_k): the per-worker DP-noise amplitude."""
        return self.h * torch.sqrt(self.beta * self.P)

    @property
    def aggregate_noise_std(self) -> torch.Tensor:
        """Per receiver: sqrt(sum_{k != i} |h_k|^2 beta_k P_k sigma^2 +
        sigma_m^2)."""
        s2 = self.noise_scale ** 2 * self.sigma.unsqueeze(-1) ** 2
        return torch.sqrt(s2.sum(-1, keepdim=True) - s2
                          + self.sigma_m.unsqueeze(-1) ** 2)

    def with_sigma(self, sigma: torch.Tensor) -> "TracedChannelState":
        return dataclasses.replace(self, sigma=sigma.to(torch.float32))

    def to(self, device) -> "TracedChannelState":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in FIELDS})

    @classmethod
    def from_static(cls, state: ChannelState,
                    device="cuda") -> "TracedChannelState":
        dev = resolve_device(device)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        return cls(h=f32(state.h), P=f32(state.P), alpha=f32(state.alpha),
                   beta=f32(state.beta), c=f32(state.c),
                   sigma=f32(state.cfg.sigma), sigma_m=f32(state.cfg.sigma_m),
                   n_workers=state.n_workers)


def stack_states(states: Sequence[TracedChannelState]) -> TracedChannelState:
    """Rounds' states stacked along a new leading axis T ([T, ...] fields),
    the input of ``core.privacy.epsilon_trajectory``."""
    states = list(states)
    return dataclasses.replace(states[0], **{
        f: torch.stack([getattr(s, f) for s in states]) for f in FIELDS})


def concat_states(chunks: Sequence[TracedChannelState]) -> TracedChannelState:
    """Stacked [K_i, ...] chunks joined into one [T, ...] trajectory."""
    chunks = list(chunks)
    return dataclasses.replace(chunks[0], **{
        f: torch.cat([getattr(s, f) for s in chunks]) for f in FIELDS})
