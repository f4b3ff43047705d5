"""repro_torch.fleet — R networks in one round, the reference's
``repro.fleet``: ``engine.FleetEngine`` (the stacked dynamic round on the
card, one dp_mix launch a flat round for all R) and the cartesian
``sweep.ScenarioGrid`` driver with mean and CI JSON rows. Batched
accounting lives in ``core.privacy`` (``epsilon_trajectory_batched``,
``compose_heterogeneous_batched``); ``fleet_epsilon_report`` wraps both.

Entry points: ``python -m repro_torch.launch.train --channel-model dynamic
--replicates R`` and ``python -m repro_torch.fleet.sweep``.
"""
from repro_torch.fleet.engine import (FleetEngine, fleet_epsilon_report,
                                      fleet_eval, fleet_round_telemetry,
                                      mean_ci, stack_rounds)

__all__ = [
    "FleetEngine", "ScenarioGrid", "fleet_epsilon_report", "fleet_eval",
    "fleet_round_telemetry", "mean_ci", "run_grid", "run_point",
    "stack_rounds",
]

_SWEEP_NAMES = {"ScenarioGrid", "run_grid", "run_point"}


def __getattr__(name):
    # lazy, so that `python -m repro_torch.fleet.sweep` does not import the
    # sweep module twice through the package
    if name in _SWEEP_NAMES:
        from repro_torch.fleet import sweep as _sweep
        return getattr(_sweep, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
