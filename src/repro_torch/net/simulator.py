"""NetworkSimulator: fading x geometry x churn into a round's channel,
participation mask and mixing matrix — the port of the reference's
``repro.net.simulator``.

A round (``round``) is tensor math over [N]-sized state on the device and
never asks the host, so a training loop around it keeps the card busy:

    fading.advance        the AR(1) block clock (redraw at block edges)
    geometry.advance      random-waypoint motion
    churn.advance         the up/down chain -> participation mask
    geometry.path_gain    log-distance gain to the centroid
    fading.channel_state  |h| = |g| sqrt(gain), re-aligned (Eqt. 3-4)
    [optional]            sigma calibrated to the round (three targets)
    mixing matrix         the masked complete graph, Metropolis weights of
                          the masked unit-disk graph (comm_radius > 0), or
                          with ``sparse_k`` > 0 the capped neighbor list
                          (``geometry.sparse_metropolis``, a SparseW: no
                          [N, N] tensor, its build in [graph_block, N] rows)

A stack of R networks (``init(generator, replicates=R)``: [R, ...]
leaves) advances in one ``round`` call with no loop over replicates (the
neighbor lists too: one stacked build): each draw takes all R at once, so at R = 1 the round draws what the single
network's round draws, in the same order, and gives its values.

Randomness: one ``torch.Generator`` drawn in that fixed order (the port's
own draws, checked in distribution). ``trajectory`` rolls the channel
alone for T rounds into the stacked state that ``protocol.
epsilon_report`` turns into the per-round epsilon trajectory. The
neighbor-list graph draws nothing, so ``sparse_k`` leaves the generator's
order as it is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import accounting, privacy
from repro_torch.core import exchange as exchange_lib
from repro_torch.core.channel import dbm_to_watts
from repro_torch.net import churn as churn_lib
from repro_torch.net import fading as fading_lib
from repro_torch.net import geometry as geometry_lib
from repro_torch.net.scenarios import Scenario
from repro_torch.net.sparse import stack_w
from repro_torch.net.state import TracedChannelState, stack_states
from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class NetState:
    fading: fading_lib.FadingState
    geometry: geometry_lib.GeometryState
    churn: churn_lib.ChurnState


# the masked complete graph lives in the exchange engine's W taxonomy;
# the reference's simulator exports it under this name
complete_mixing = exchange_lib.masked_complete_W


class NetworkSimulator:
    """Holds the scenario and the protocol's power, noise and calibration
    knobs; the state is a ``NetState`` the caller threads through."""

    def __init__(self, scenario: Scenario, n_workers: int, *,
                 p_dbm: float = 60.0, sigma: float = 1.0,
                 sigma_m: float = 1.0, noise_policy: str = "surplus",
                 beta_slack: float = 1.0, coherence_rounds: int = 0,
                 target_epsilon: float = 0.0, gamma: float = 0.05,
                 clip: float = 1.0, delta: float = 1e-5,
                 sparse_k: int = 0, graph_fallback: bool = False,
                 graph_block: int = 0, target_total_epsilon: float = 0.0,
                 horizon: int = 0, accountant: str = "composition",
                 device="cuda"):
        if coherence_rounds > 0:
            scenario = scenario.with_coherence(coherence_rounds)
        self.device = resolve_device(device)
        self.scenario = scenario
        self.n_workers = int(n_workers)
        self.P = float(dbm_to_watts(p_dbm))
        self.sigma = float(sigma)
        self.sigma_m = float(sigma_m)
        self.noise_policy = noise_policy
        self.beta_slack = float(beta_slack)
        self.target_epsilon = float(target_epsilon)
        self.gamma, self.clip, self.delta = (float(gamma), float(clip),
                                             float(delta))
        self.graph_fallback = bool(graph_fallback)
        # a total budget's per-round share (an RDP rate, or a delta-split
        # advanced-composition epsilon) is a host float fixed here
        self.target_total_epsilon = float(target_total_epsilon)
        self.accountant = accountant
        self._rho_round = self._eps_round_split = self._delta_round = None
        if self.target_total_epsilon > 0:
            if self.target_epsilon > 0:
                raise ValueError("target_epsilon and target_total_epsilon "
                                 "are mutually exclusive")
            if horizon < 1:
                raise ValueError("target_total_epsilon needs horizon >= 1")
            if accountant == "rdp":
                self._rho_round = accounting.rho_total_for_epsilon(
                    self.target_total_epsilon, self.delta) / horizon
            elif accountant == "composition":
                self._eps_round_split, self._delta_round = (
                    accounting.epsilon_round_for_total_advanced(
                        self.target_total_epsilon, self.delta, horizon))
            else:
                raise ValueError(f"accountant must be 'rdp' or "
                                 f"'composition', got {accountant!r}")
        # sparse_k > 0: each round's W is the capped neighbor list
        # (sparse.SparseW, degree <= sparse_k), built over [graph_block, N]
        # row blocks (0: min(1024, N))
        self.sparse_k = int(sparse_k)
        if self.sparse_k > self.n_workers:
            raise ValueError(f"sparse_k={sparse_k} exceeds n_workers="
                             f"{n_workers}")
        if self.sparse_k > 0 and scenario.geometry.comm_radius <= 0:
            raise ValueError(
                "sparse_k requires a unit-disk scenario (comm_radius > 0); "
                f"scenario {scenario.name!r} has no interference radius")
        self.graph_block = (int(graph_block) if graph_block
                            else min(1024, self.n_workers))

    def init(self, generator: torch.Generator,
             replicates: Optional[int] = None) -> NetState:
        """The initial state; with ``replicates`` R, a stack of R networks
        ([R, ...] leaves)."""
        scn, n = self.scenario, self.n_workers
        lead = () if replicates is None else (int(replicates),)
        return NetState(
            fading=fading_lib.init_fading(scn.fading, generator, n, lead),
            geometry=geometry_lib.init_geometry(scn.geometry, generator, n,
                                                lead),
            churn=churn_lib.init_churn(scn.churn, generator, n, lead))

    def _channel(self, state: NetState, W, P=None) -> TracedChannelState:
        scn = self.scenario
        gains = geometry_lib.path_gain(scn.geometry, state.geometry.pos)
        chan = fading_lib.channel_state(
            scn.fading, state.fading, self.P if P is None else P,
            self.sigma, self.sigma_m,
            path_gain=gains, noise_policy=self.noise_policy,
            beta_slack=self.beta_slack)
        # each target calibrates against the round's actual masking
        # neighborhoods (limited range and churn leave fewer than N - 1)
        if self.target_epsilon > 0:
            sig = privacy.sigma_for_epsilon_traced(
                self.target_epsilon, self.gamma, self.clip, chan, self.delta,
                W)
        elif self._rho_round is not None:
            sig = accounting.sigma_for_rho_traced(
                self._rho_round, self.gamma, self.clip, chan, W)
        elif self._eps_round_split is not None:
            sig = privacy.sigma_for_epsilon_traced(
                self._eps_round_split, self.gamma, self.clip, chan,
                self._delta_round, W)
        else:
            return chan
        return chan.with_sigma(torch.clamp_min(sig, 1e-12))

    def round(self, generator: torch.Generator, state: NetState, P=None
              ) -> Tuple[NetState, TracedChannelState, torch.Tensor,
                         torch.Tensor]:
        """One round: (state', chan, mask [N] bool, W), all on the device;
        W is [N, N], or a SparseW when ``sparse_k`` > 0. ``state`` is left
        as it was. A stacked state ([R, ...] leaves) advances all R
        networks: chan's leaves [R, ...], mask [R, N], W [R, N, N] (a
        SparseW of [R, N, k] leaves, all R lists built in one call).

        ``P``: this call's transmit power in watts in place of the
        constructor's ``p_dbm`` — a number, a tensor [N], or for a stack
        [R, 1] (each network its own power)."""
        scn = self.scenario
        state = NetState(
            fading=fading_lib.advance(scn.fading, generator, state.fading),
            geometry=geometry_lib.advance(scn.geometry, generator,
                                          state.geometry),
            churn=churn_lib.advance(scn.churn, generator, state.churn))
        mask = churn_lib.participation_mask(scn.churn, generator, state.churn)
        if self.sparse_k > 0:
            W = geometry_lib.sparse_metropolis(
                scn.geometry, state.geometry.pos, self.sparse_k, mask=mask,
                fallback=self.graph_fallback, block=self.graph_block)
        elif scn.geometry.comm_radius > 0:
            W = geometry_lib.metropolis_weights(geometry_lib.adjacency(
                scn.geometry, state.geometry.pos, mask=mask,
                fallback=self.graph_fallback))
        else:
            W = complete_mixing(mask)
        return state, self._channel(state, W, P), mask, W

    def trajectory(self, generator: torch.Generator, T: int,
                   state: Optional[NetState] = None, P=None
                   ) -> Tuple[TracedChannelState, torch.Tensor, torch.Tensor]:
        """T rounds of the channel alone (no model): the stacked state
        ([T, ...] fields), the [T, N] masks and the [T, N, N] mixing
        matrices (a SparseW of [T, N, k] leaves when ``sparse_k`` > 0), for
        ``protocol.epsilon_report``. ``P`` as in ``round``."""
        if state is None:
            state = self.init(generator)
        chans, masks, Ws = [], [], []
        for _ in range(int(T)):
            state, chan, mask, W = self.round(generator, state, P)
            chans.append(chan)
            masks.append(mask)
            Ws.append(W)
        return stack_states(chans), torch.stack(masks), stack_w(Ws)
