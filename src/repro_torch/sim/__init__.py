"""Discrete-event cluster simulator + metrics (paper-scale experiments).

``ClusterSim`` is the event-indexed production core.  The JAX package's
frozen pre-rewrite oracle, ``repro.sim.reference.ReferenceClusterSim``, is
not copied here: the port's sim is held against the JAX package's
``ClusterSim`` by its tests, and the frozen oracle waits with the frozen
engine oracle (ROADMAP §1 item 4).
"""

from repro_torch.sim.cluster import ClusterSim, SimAgent, SimResult
from repro_torch.sim.metrics import (
    FairnessStats,
    JctStats,
    fair_ratios,
    fairness_stats,
    jct_stats,
)

__all__ = [
    "ClusterSim",
    "SimAgent",
    "SimResult",
    "FairnessStats",
    "JctStats",
    "fair_ratios",
    "fairness_stats",
    "jct_stats",
]
