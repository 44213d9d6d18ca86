"""Readings that the output check's limit is set from, on the card.

    python3 bench/calibrate.py --workload granite-3-2b.agents-open \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control 1,2,3 --seconds 20

For each seed, in one process: serve the cell's traffic for ``--seconds``
at the cell's own load and sizes, drain it, and read the widest gap of
the served tokens below the float32 reference's best
(``served_gap``).  For the ``--control`` seeds, also read the control on
the same prompts and tokens: the gap of the token the reference computed
with fp8 operands puts first (``control_gap``).  One JSON line a seed;
the run's result line is not printed.  The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell_of(args.workload)
    for seed in args.seeds:
        run = harness.Run(cell, seed, args.seconds)
        run.setup()
        run.serve()
        sample = run.sample()
        run.free_program()
        row = {"seed": seed, "served_gap": run.served_gaps(sample),
               "count_errors": run.count_errors(),
               "requests": len(sample),
               "tokens": sum(len(s) for _, s in sample),
               "attempted": len(run.attempted()),
               "failed": sum(a not in run.rec.done for a in run.attempted()),
               "setup_s": run.setup_s}
        if seed in args.control:
            row["control_gap"] = run.served_gaps(sample, control=True)
        print(json.dumps(row), flush=True)
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
