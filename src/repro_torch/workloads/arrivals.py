"""Arrival-time synthesis following the Mooncake production trace shape.

The paper replays request arrival times from the Mooncake trace (Qin et al.,
2024) with submission windows of 6/9/18 minutes (3x/2x/1x density).  The
trace itself is not bundled offline; we synthesize arrivals with the same
statistical character reported for it — bursty arrivals, i.e. a doubly
stochastic (Cox) process: Poisson arrivals whose rate is modulated by a
Gamma-renewal burst process — and note the substitution in DESIGN.md §7.
"""

from __future__ import annotations

import numpy as np

DENSITY_WINDOWS_S = {1: 18 * 60.0, 2: 9 * 60.0, 3: 6 * 60.0}


def mooncake_like_arrivals(
    rng: np.random.Generator,
    n: int,
    window_s: float,
    burstiness: float = 2.5,
) -> np.ndarray:
    """n sorted arrival times in [0, window_s] with bursty clustering."""
    if n <= 0:
        return np.zeros(0)
    # burst centers from a Gamma renewal process
    n_bursts = max(1, int(n / 12))
    centers = np.sort(rng.uniform(0.0, window_s, size=n_bursts))
    weights = rng.gamma(shape=1.0 / burstiness, scale=burstiness, size=n_bursts)
    weights = weights / weights.sum()
    counts = rng.multinomial(n, weights)
    times = []
    for c, k in zip(centers, counts):
        if k == 0:
            continue
        spread = window_s / n_bursts / 2.0
        times.append(np.clip(rng.normal(c, spread, size=k), 0.0, window_s))
    t = np.sort(np.concatenate(times)) if times else np.zeros(0)
    # pad if multinomial rounding dropped any (it cannot, but be safe)
    if t.size < n:
        t = np.sort(np.concatenate([t, rng.uniform(0, window_s, n - t.size)]))
    return t


def arrivals_for_density(
    rng: np.random.Generator, n: int, density: int
) -> np.ndarray:
    return mooncake_like_arrivals(rng, n, DENSITY_WINDOWS_S[density])
