"""Open loop: independent users.  ``rate_per_s`` x ``--seconds`` agents
fall due over the window at bursty times (``mooncake_like_arrivals`` with
``burstiness``), whether or not earlier ones have finished."""

from __future__ import annotations

from traffic import generator
from traffic.arrivals import mooncake_like_arrivals


def pool_size(mix: dict, seconds: float) -> int:
    """The window's due agents."""
    return max(1, int(round(float(mix["rate_per_s"]) * seconds)))


class Source:
    """``plan``: (due second within the window, agent), sorted by due
    time; every agent falls due inside the window."""

    def __init__(self, mix: dict, seed: int, seconds: float, vocab: int):
        pool = generator.agent_pool(mix, seconds)
        due = mooncake_like_arrivals(generator.pool_rng(mix, 3), len(pool),
                                     seconds, float(mix["burstiness"]))
        order = generator.order(len(pool), seed)
        self.plan = [(float(t), generator.agent(pool[int(i)], int(i), seed,
                                                vocab))
                     for t, i in zip(due, order)]
        self.longest = max(p for _, a in self.plan for p, _ in a.inferences)
        self.i = 0

    def offer(self, run, now: float) -> bool:
        plan = self.plan
        while self.i < len(plan) and run.t0 + plan[self.i][0] <= now:
            run.submit(plan[self.i][1], run.t0 + plan[self.i][0])
            self.i += 1
        return not (now >= run.end and self.i == len(plan))

    def next_due(self, run) -> float:
        if self.i < len(self.plan):
            return run.t0 + self.plan[self.i][0]
        return run.end
