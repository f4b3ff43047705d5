"""Named network scenarios: fading, geometry and churn presets — the
reference's ``repro.net.scenarios`` with its numbers. Power and the noise
stds stay protocol knobs: a scenario is the radio environment.

    static_paper  the paper's Sec. III channel as a dynamic case: one
                  Rayleigh draw held forever, no geometry, no churn;
    iot_dense     dense static sensors in a hall: slow quasi-static
                  fading, short radio range, duty-cycle churn;
    vehicular     cars at street speed: a fresh fading block every round,
                  km-scale path loss, waypoint mobility, stragglers;
    drone_sparse  a sparse aerial swarm with line of sight: Rician K = 6,
                  clustered launch sites, fast motion, battery churn;
    mesh_sparse   a city-scale static mesh whose radio range is far below
                  its area (the neighbor-list path, ``sparse_k`` /
                  ``--sparse-neighbors``, is made for it; the dense path
                  runs it as well).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

from repro_torch.net.churn import ChurnConfig
from repro_torch.net.fading import FadingConfig
from repro_torch.net.geometry import GeometryConfig


@dataclass(frozen=True)
class Scenario:
    name: str
    fading: FadingConfig
    geometry: GeometryConfig
    churn: ChurnConfig
    description: str = ""

    def with_coherence(self, coherence_rounds: int) -> "Scenario":
        """The scenario with another fading block length."""
        return replace(self, fading=replace(self.fading,
                                            coherence_rounds=coherence_rounds))


SCENARIOS: Dict[str, Scenario] = {
    "static_paper": Scenario(
        name="static_paper",
        fading=FadingConfig(kind="rayleigh", rho=1.0,
                            coherence_rounds=1_000_000_000),
        geometry=GeometryConfig(mobility="static", pl_exponent=0.0,
                                comm_radius=0.0),
        churn=ChurnConfig(),
        description="one Rayleigh draw held for the whole run; complete "
                    "graph; no churn — the paper's static model",
    ),
    "iot_dense": Scenario(
        name="iot_dense",
        fading=FadingConfig(kind="rayleigh", rho=0.95, coherence_rounds=20),
        geometry=GeometryConfig(area=200.0, placement="uniform",
                                pl_exponent=2.5, ref_distance=1.0,
                                ref_gain_db=0.0, mobility="static",
                                comm_radius=90.0),
        churn=ChurnConfig(p_drop=0.02, p_join=0.3, straggler_rate=0.05),
        description="dense static sensor hall: quasi-static fading, short "
                    "range, duty-cycle churn",
    ),
    "vehicular": Scenario(
        name="vehicular",
        fading=FadingConfig(kind="rayleigh", rho=0.3, coherence_rounds=1),
        geometry=GeometryConfig(area=1000.0, placement="uniform",
                                pl_exponent=3.2, ref_distance=10.0,
                                ref_gain_db=0.0, mobility="waypoint",
                                speed_min=5.0, speed_max=20.0,
                                comm_radius=450.0),
        churn=ChurnConfig(p_drop=0.0, p_join=1.0, straggler_rate=0.1),
        description="street-speed mobility: a fresh fading block every "
                    "round, km-scale path loss, deadline stragglers",
    ),
    "mesh_sparse": Scenario(
        name="mesh_sparse",
        fading=FadingConfig(kind="rayleigh", rho=0.9, coherence_rounds=10),
        geometry=GeometryConfig(area=1000.0, placement="uniform",
                                pl_exponent=2.8, ref_distance=1.0,
                                ref_gain_db=0.0, mobility="static",
                                comm_radius=60.0),
        churn=ChurnConfig(p_drop=0.01, p_join=0.5, straggler_rate=0.02),
        description="city-scale static mesh: thousands of nodes, radio "
                    "range far below the deployment area — the worker-"
                    "scale O(N·k) sparse-mixing regime (degree stays "
                    "geometry-limited as N grows; pair with "
                    "sparse_neighbors>0)",
    ),
    "drone_sparse": Scenario(
        name="drone_sparse",
        fading=FadingConfig(kind="rician", rician_k=6.0, rho=0.8,
                            coherence_rounds=5),
        geometry=GeometryConfig(area=1500.0, placement="cluster",
                                n_clusters=3, cluster_std=120.0,
                                pl_exponent=2.2, ref_distance=10.0,
                                ref_gain_db=0.0, mobility="waypoint",
                                speed_min=8.0, speed_max=30.0,
                                comm_radius=700.0),
        churn=ChurnConfig(p_drop=0.03, p_join=0.15, straggler_rate=0.02),
        description="sparse LOS swarm: Rician fading, clustered launch "
                    "sites, battery churn",
    ),
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(SCENARIOS)}") from None
