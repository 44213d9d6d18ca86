"""Agent workload suite: the paper's 9 agent classes + arrival synthesis."""

from repro_torch.workloads.agents import (
    AGENT_CLASSES,
    CANON_VOCAB,
    CLOSED_LOOP_CLASSES,
    SIZE_BUCKETS,
    SIZE_PROBS,
    SLO_CLASSES,
    SLO_TIERS,
    AgentClass,
    ClosedLoopClass,
    ClosedLoopSession,
    SampledAgent,
    family_prefix_ids,
    sample_agent,
    sample_closed_loop,
    sample_mixed_suite,
    skew_normal,
    slo_tier_of,
)
from repro_torch.workloads.arrivals import (
    DENSITY_WINDOWS_S,
    arrivals_for_density,
    mooncake_like_arrivals,
)

__all__ = [
    "AGENT_CLASSES",
    "CANON_VOCAB",
    "CLOSED_LOOP_CLASSES",
    "SIZE_BUCKETS",
    "SIZE_PROBS",
    "SLO_CLASSES",
    "SLO_TIERS",
    "slo_tier_of",
    "AgentClass",
    "ClosedLoopClass",
    "ClosedLoopSession",
    "SampledAgent",
    "family_prefix_ids",
    "sample_agent",
    "sample_closed_loop",
    "sample_mixed_suite",
    "skew_normal",
    "DENSITY_WINDOWS_S",
    "arrivals_for_density",
    "mooncake_like_arrivals",
]
