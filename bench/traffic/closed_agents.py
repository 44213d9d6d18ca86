"""Closed loop: ``clients`` clients, each submitting its next agent as
soon as its last one completed (due at that completion), the clients'
first agents started ``stagger_s`` apart in all.  The agents come from a
pool of ``pool_size``, handed out in the seed's order, round the pool."""

from __future__ import annotations

from traffic import generator


def pool_size(mix: dict, seconds: float) -> int:
    return int(mix["pool_size"])


class Source:
    """``starts``: the clients' first submission offsets within the
    window; ``next()`` hands out the next agent."""

    def __init__(self, mix: dict, seed: int, seconds: float, vocab: int):
        self.pool = generator.agent_pool(mix, seconds)
        self.order = generator.order(len(self.pool), seed)
        self.seed, self.vocab = int(seed), int(vocab)
        self.handed = 0
        n = int(mix["clients"])
        self.starts = [float(mix["stagger_s"]) * c / n for c in range(n)]
        self.longest = max(p for a in self.pool for st in a.stages
                           for p, _ in st)
        self.held: dict[int, int] = {}     # client -> its agent
        self.started = 0

    def next(self) -> generator.Agent:
        i = int(self.order[self.handed % len(self.order)])
        self.handed += 1
        return generator.agent(self.pool[i], i, self.seed, self.vocab)

    def offer(self, run, now: float) -> bool:
        if now >= run.end:
            return False
        starts, held = self.starts, self.held
        while (self.started < len(starts)
               and run.t0 + starts[self.started] <= now):
            held[self.started] = run.submit(self.next(),
                                            run.t0 + starts[self.started])
            self.started += 1
        done = run.rec.done
        for client, aid in list(held.items()):
            if aid in done:
                held[client] = run.submit(self.next(), done[aid])
        return True

    def next_due(self, run) -> float:
        if self.started < len(self.starts):
            return run.t0 + self.starts[self.started]
        return run.end
