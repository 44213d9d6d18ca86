"""Metrics for the paper's evaluation (§5.1 Metrics).

Efficiency: average / P90 job completion time (JCT).
Fairness: finish-time fair ratio — a job's completion time under a reference
fair scheduler (VTC in the paper's Fig. 8; GPS for the theorem check)
divided by its realistic completion time.  Ratio >= 1 means the job was not
delayed relative to the fair reference.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class JctStats:
    mean: float
    p50: float
    p90: float
    p99: float
    n: int

    def row(self) -> str:
        return (
            f"mean={self.mean:.1f}s p50={self.p50:.1f}s "
            f"p90={self.p90:.1f}s p99={self.p99:.1f}s n={self.n}"
        )


def jct_stats(jct: Mapping[int, float]) -> JctStats:
    v = np.asarray(sorted(jct.values()), dtype=np.float64)
    if v.size == 0:
        return JctStats(0.0, 0.0, 0.0, 0.0, 0)
    return JctStats(
        mean=float(v.mean()),
        p50=float(np.percentile(v, 50)),
        p90=float(np.percentile(v, 90)),
        p99=float(np.percentile(v, 99)),
        n=int(v.size),
    )


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Per-request latency percentiles: TTFT (arrival -> first streamed
    token, queueing-inclusive) and TBT (mean inter-token gap within a
    request's decode, excluding cross-stage idle/queueing gaps)."""

    ttft_mean: float
    ttft_p50: float
    ttft_p90: float
    ttft_p99: float
    tbt_mean: float
    tbt_p50: float
    tbt_p90: float
    tbt_p99: float
    n_ttft: int
    n_tbt: int

    def row(self) -> str:
        return (
            f"ttft mean={self.ttft_mean:.2f}s p50={self.ttft_p50:.2f}s "
            f"p99={self.ttft_p99:.2f}s (n={self.n_ttft}) | "
            f"tbt mean={self.tbt_mean:.3f}s p99={self.tbt_p99:.3f}s "
            f"(n={self.n_tbt})"
        )


def _pcts(values) -> tuple[float, float, float, float, int]:
    v = np.asarray(sorted(values), dtype=np.float64)
    if v.size == 0:
        return 0.0, 0.0, 0.0, 0.0, 0
    return (
        float(v.mean()),
        float(np.percentile(v, 50)),
        float(np.percentile(v, 90)),
        float(np.percentile(v, 99)),
        int(v.size),
    )


def latency_stats(ttfts, tbts) -> LatencyStats:
    """Percentile summary over TTFT / TBT samples (mappings or sequences)."""
    if isinstance(ttfts, Mapping):
        ttfts = ttfts.values()
    if isinstance(tbts, Mapping):
        tbts = tbts.values()
    tf = _pcts(ttfts)
    tb = _pcts(tbts)
    return LatencyStats(
        ttft_mean=tf[0], ttft_p50=tf[1], ttft_p90=tf[2], ttft_p99=tf[3],
        tbt_mean=tb[0], tbt_p50=tb[1], tbt_p90=tb[2], tbt_p99=tb[3],
        n_ttft=tf[4], n_tbt=tb[4],
    )


@dataclasses.dataclass(frozen=True)
class SloTier:
    """One latency tier's targets, in workload seconds (Equinox-style
    per-class SLOs: an agent attains its tier iff BOTH hold)."""

    name: str
    ttft: float       # max time-to-first-token
    tbt: float        # max mean time-between-tokens


@dataclasses.dataclass(frozen=True)
class SloStats:
    attainment: float                 # frac of agents meeting BOTH targets
    ttft_attainment: float
    tbt_attainment: float
    per_tier: dict[str, float]        # tier name -> joint attainment
    n: int

    def row(self) -> str:
        tiers = " ".join(
            f"{name}={frac:.2f}" for name, frac in sorted(self.per_tier.items())
        )
        return (
            f"slo={self.attainment:.2f} (ttft {self.ttft_attainment:.2f}, "
            f"tbt {self.tbt_attainment:.2f}) [{tiers}] n={self.n}"
        )


def slo_attainment(
    ttfts: Mapping[int, float],
    tbts: Mapping[int, float],
    tiers: Mapping[int, SloTier],
) -> SloStats:
    """SLO attainment over the agents that have a tier assignment.

    An agent without a TTFT sample (never streamed a token) misses its
    tier; an agent without a TBT sample (single-token decodes) vacuously
    attains the TBT half.
    """
    n = ok = ok_ttft = ok_tbt = 0
    per_tier_n: dict[str, int] = {}
    per_tier_ok: dict[str, int] = {}
    for aid, tier in tiers.items():
        n += 1
        per_tier_n[tier.name] = per_tier_n.get(tier.name, 0) + 1
        ttft = ttfts.get(aid)
        a_ttft = ttft is not None and ttft <= tier.ttft
        tbt = tbts.get(aid)
        a_tbt = tbt is None or tbt <= tier.tbt
        ok_ttft += a_ttft
        ok_tbt += a_tbt
        if a_ttft and a_tbt:
            ok += 1
            per_tier_ok[tier.name] = per_tier_ok.get(tier.name, 0) + 1
    if n == 0:
        return SloStats(1.0, 1.0, 1.0, {}, 0)
    return SloStats(
        attainment=ok / n,
        ttft_attainment=ok_ttft / n,
        tbt_attainment=ok_tbt / n,
        per_tier={
            name: per_tier_ok.get(name, 0) / cnt
            for name, cnt in per_tier_n.items()
        },
        n=n,
    )


def fair_ratios(
    realistic_jct: Mapping[int, float], reference_jct: Mapping[int, float]
) -> dict[int, float]:
    """finish-time fair ratio per agent: reference / realistic (higher=better)."""
    out = {}
    for k, real in realistic_jct.items():
        ref = reference_jct.get(k)
        if ref is None or real <= 0:
            continue
        out[k] = ref / real
    return out


@dataclasses.dataclass(frozen=True)
class FairnessStats:
    frac_not_delayed: float      # ratio >= 1 (within tolerance)
    worst_delay_pct: float       # max relative delay among delayed agents
    mean_delay_pct_of_delayed: float
    n: int


def fairness_stats(ratios: Mapping[int, float], tol: float = 1e-6) -> FairnessStats:
    r = np.asarray(list(ratios.values()), dtype=np.float64)
    if r.size == 0:
        return FairnessStats(1.0, 0.0, 0.0, 0)
    delayed = r[r < 1.0 - tol]
    delay_pct = (1.0 / np.maximum(delayed, 1e-12) - 1.0) * 100.0
    return FairnessStats(
        frac_not_delayed=float((r >= 1.0 - tol).mean()),
        worst_delay_pct=float(delay_pct.max()) if delayed.size else 0.0,
        mean_delay_pct_of_delayed=float(delay_pct.mean()) if delayed.size else 0.0,
        n=int(r.size),
    )
