"""The knee of an open-loop cell, by a sweep of arrival rates on the card.

    python3 bench/sweep.py --workload granite-3-2b.agents-open \\
        --rates 1.0,1.5,2.0,2.5,3.0 --seconds 50 --seed 1

For each rate, in one process: serve the cell's traffic at that rate for
``--seconds`` and drain it by the run's deadline, then print one JSON line:
the agents due and failed, the mean number of agents in the system over
the window's first and second halves, the JCTs and the tokens per second.
The knee is the highest rate at which no agent fails and the second
half's backlog is no larger than the first's; the cell runs at four
fifths of it (``rate_per_s`` in its traffic file).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def backlog(run, lo: float, hi: float, step: float = 0.25) -> float:
    """Mean number of agents submitted and not yet complete over
    [lo, hi) (host clock)."""
    rec = run.rec
    grid = np.arange(lo, hi, step)
    sub = np.array([rec.submit[a] for a in run.attempted()])
    done = np.array([rec.done.get(a, np.inf) for a in run.attempted()])
    return float(np.mean([np.sum((sub <= t) & (done > t)) for t in grid]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell_of(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        run = harness.Run(cell, args.seed, args.seconds,
                          overrides={"traffic": {"rate_per_s": rate}})
        run.setup()
        run.serve()
        mid = run.t0 + args.seconds / 2
        e2e = run.end_to_end()
        print(json.dumps({
            "rate_per_s": rate, "due": len(run.attempted()),
            "failed": sum(a not in run.rec.done for a in run.attempted()),
            "backlog_first": backlog(run, run.t0, mid),
            "backlog_second": backlog(run, mid, run.end),
            "jct_mean_s": e2e["jct_mean_s"], "jct_p90_s": e2e["jct_p90_s"],
            "tokens_per_s": e2e["tokens_per_s"],
            "swaps": run.engine.metrics["swaps"],
            "drain_s": run.drain_end - run.window_end,
        }), flush=True)
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
