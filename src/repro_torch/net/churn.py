"""Worker churn and stragglers — the port of the reference's
``repro.net.churn``.

Each worker's availability is a two-state Markov chain (P(up -> down) =
``p_drop``, P(down -> up) = ``p_join``): devices leaving and rejoining.
On top of it an i.i.d. straggler coin (``straggler_rate``) takes an
otherwise-up worker out for one round. Under the dynamic channel the mask
also zeroes the worker's row and column of the interference graph, so it
neither sends, mixes nor masks anyone's aggregate that round.
``min_active`` forces the first workers on, so every round has an
exchange (a fixed subset, unlike the randomized pair of the static
sampling path, ``protocol.sample_participation``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ChurnConfig:
    p_drop: float = 0.0          # P(up -> down) per round
    p_join: float = 1.0          # P(down -> up) per round
    straggler_rate: float = 0.0  # per-round miss rate among up workers
    min_active: int = 2

    @property
    def stationary_up(self) -> float:
        """The chain's long-run P(up)."""
        denom = self.p_drop + self.p_join
        return 1.0 if denom == 0 else self.p_join / denom


@dataclass(frozen=True)
class ChurnState:
    up: torch.Tensor   # [N] float32 in {0, 1}


def _rand(generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def init_churn(cfg: ChurnConfig, generator: torch.Generator,
               n_workers: int, lead: tuple = ()) -> ChurnState:
    """Start from the stationary distribution (everyone up at the start
    would bias short trajectories' privacy optimistic). ``lead``: leading
    axes of a stack of networks."""
    return ChurnState(up=(_rand(generator, lead + (n_workers,))
                          < cfg.stationary_up).to(torch.float32))


def advance(cfg: ChurnConfig, generator: torch.Generator,
            state: ChurnState) -> ChurnState:
    if cfg.p_drop <= 0.0 and cfg.p_join >= 1.0:
        return ChurnState(up=torch.ones_like(state.up))
    u = _rand(generator, state.up.shape)
    up = torch.where(state.up > 0, u >= cfg.p_drop, u < cfg.p_join)
    return ChurnState(up=up.to(torch.float32))


def participation_mask(cfg: ChurnConfig, generator: torch.Generator,
                       state: ChurnState) -> torch.Tensor:
    """Bool [..., N]: up and not straggling this round, the first
    ``min_active`` workers forced on."""
    mask = state.up > 0
    n = mask.shape[-1]
    if cfg.straggler_rate > 0.0:
        mask = mask & (_rand(generator, mask.shape) >= cfg.straggler_rate)
    if cfg.min_active > 0:
        mask = mask | (torch.arange(n, device=mask.device) < cfg.min_active)
    return mask
