"""The dynamic wireless network of DWFL — the port of the reference's
``repro.net``: block fading (``fading``), geometry, path loss and mobility
(``geometry``), churn (``churn``), scenario presets (``scenarios``) and
the ``NetworkSimulator`` that composes them into a round's channel
(``state.TracedChannelState``), participation mask and mixing matrix —
dense, or the capped neighbor list of ``sparse`` (``sparse_k`` > 0).

Entry points: ``ProtocolConfig(channel_model="dynamic", scenario=...)``
with ``protocol.make_dynamic_train_step`` or
``make_dynamic_flat_train_step``, and ``python -m
repro_torch.launch.train --channel-model dynamic --scenario ...``.
"""
from repro_torch.net.churn import ChurnConfig, ChurnState
from repro_torch.net.fading import FadingConfig, FadingState, rho_from_doppler
from repro_torch.net.geometry import GeometryConfig, GeometryState
from repro_torch.net.scenarios import SCENARIOS, Scenario, get_scenario
from repro_torch.net.simulator import NetState, NetworkSimulator, complete_mixing
from repro_torch.net.sparse import SparseW, isolated_count, sparsify_dense
from repro_torch.net.state import TracedChannelState, stack_states

__all__ = [
    "ChurnConfig", "ChurnState", "FadingConfig", "FadingState",
    "GeometryConfig", "GeometryState", "NetState", "NetworkSimulator",
    "SCENARIOS", "Scenario", "SparseW", "TracedChannelState",
    "complete_mixing", "get_scenario", "isolated_count", "rho_from_doppler",
    "sparsify_dense", "stack_states",
]
