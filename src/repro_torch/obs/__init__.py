"""repro_torch.obs — observability of the port, the reference's
``repro.obs``.

Two halves:

* on the device (``obs.telemetry``): ``TelemetrySpec`` threads through
  ``core.trajectory.make_round_body`` and selects per-round scalars —
  loss, gradient norm, consensus distance, realized SNR, deep-fade share,
  participation, per-round epsilon — returned as one stacked [K, M]
  tensor a chunk, with the epsilon composition moments accumulated in the
  carry;
* on the host (``obs.runlog``, ``obs.report``): run directories
  (manifest.json + events.jsonl) in the reference's format, the
  epsilon-budget and retrace watchdogs, and ``python -m
  repro_torch.obs.report``.

``obs.guard`` holds the hot loop's guards: ``no_implicit_transfers``
(sync-debug mode "error" on the card) and ``retrace_guard``.
"""
from repro_torch.obs.guard import (RetraceError, no_implicit_transfers,
                                   retrace_guard)
from repro_torch.obs.runlog import (EpsilonBudgetWatchdog, RetraceWatchdog,
                                    RunLog, config_hash, console, git_sha)
from repro_torch.obs.telemetry import (TelemetrySpec, accumulate_eps,
                                       channel_scalars, consensus_distance,
                                       epsilon_round, init_eps_moments)

__all__ = [
    "EpsilonBudgetWatchdog", "RetraceError", "RetraceWatchdog", "RunLog",
    "TelemetrySpec", "accumulate_eps", "channel_scalars",
    "config_hash", "console", "consensus_distance", "epsilon_round",
    "git_sha", "init_eps_moments", "no_implicit_transfers",
    "retrace_guard",
]
