"""Discrete-event cluster simulator + metrics (paper-scale experiments).

``ClusterSim`` is the event-indexed production core;
``reference.ReferenceClusterSim`` is the retained pre-rewrite oracle, a
verbatim copy of the JAX package's, that the port's tests pin it against.
"""

from repro_torch.sim.cluster import ClusterSim, SimAgent, SimResult
from repro_torch.sim.metrics import (
    FairnessStats,
    JctStats,
    fair_ratios,
    fairness_stats,
    jct_stats,
)
from repro_torch.sim.reference import ReferenceClusterSim

__all__ = [
    "ClusterSim",
    "ReferenceClusterSim",
    "SimAgent",
    "SimResult",
    "FairnessStats",
    "JctStats",
    "fair_ratios",
    "fairness_stats",
    "jct_stats",
]
