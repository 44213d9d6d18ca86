"""Bursty arrival times, frozen: a copy of the port's
``repro_torch/workloads/arrivals.py`` ``mooncake_like_arrivals``.

A doubly stochastic (Cox) process shaped like the Mooncake trace's
arrivals: Poisson arrivals whose rate a Gamma-renewal burst process
modulates.
"""

from __future__ import annotations

import numpy as np


def mooncake_like_arrivals(rng: np.random.Generator, n: int, window_s: float,
                           burstiness: float = 2.5) -> np.ndarray:
    """n sorted arrival times in [0, window_s] with bursty clustering."""
    if n <= 0:
        return np.zeros(0)
    n_bursts = max(1, int(n / 12))
    centers = np.sort(rng.uniform(0.0, window_s, size=n_bursts))
    weights = rng.gamma(shape=1.0 / burstiness, scale=burstiness,
                        size=n_bursts)
    weights = weights / weights.sum()
    counts = rng.multinomial(n, weights)
    times = []
    for c, k in zip(centers, counts):
        if k == 0:
            continue
        spread = window_s / n_bursts / 2.0
        times.append(np.clip(rng.normal(c, spread, size=k), 0.0, window_s))
    t = np.sort(np.concatenate(times)) if times else np.zeros(0)
    if t.size < n:
        t = np.sort(np.concatenate([t, rng.uniform(0, window_s,
                                                    n - t.size)]))
    return t
