"""A rehearsal of a cell on the CPU: the harness end to end at a reduced
width, with the kernels' plain versions, for a few seconds.

    python3 bench/rehearse.py --workload granite-3-2b.agents-open

It finds faults in the harness's paths, arguments and control flow
before a chip call.  It prints what it counted (agents, tokens, the
output check) and never the result line or a metric: nothing timed here
says anything about the card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

#: the reduced width: the configuration's family and window at 2 layers of
#: d 256 (hd 64), float32
SMALL = {"hidden_size": 256, "intermediate_size": 512,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "vocab_size": 1024, "dtype": "float32"}
#: each mix shrunk to what the CPU serves in a few seconds
SMALL_TRAFFIC = {
    "open_agents": {"rate_per_s": 2.0,
                    "engine": {"max_batch": 8, "pool_tokens": 4096}},
    "closed_agents": {"clients": 3, "stagger_s": 0.5,
                      "engine": {"max_batch": 8, "pool_tokens": 16384}},
}


def overrides(cell: dict, limit: float = 1e-3, **traffic) -> dict:
    """The rehearsal's overrides of ``cell``: the small width, the small
    mix (with ``traffic`` on top) and the check's limit (float32 on both
    sides agrees to rounding)."""
    import harness
    from traffic import generator

    kind = generator.load(cell["traffic"])["kind"]
    tr = {**SMALL_TRAFFIC[kind], **traffic}
    if harness.load_config(cell["config"])["family"] != "dense":
        raise ValueError(f"SMALL is a dense width; {cell['config']} is not "
                         "dense")
    return {"config": SMALL, "traffic": tr, "limit": limit}


def rehearse(name: str, seconds: float = 4.0, seed: int = 123456789012,
             trace: bool = False, limit: float = 1e-3, **traffic):
    """Run the cell at the reduced width on the CPU; returns the result
    fields and the run."""
    import torch

    import harness

    torch.set_num_threads(2)   # steady on a CPU that other work shares
    cell = harness.cell_of(name)
    return harness.execute(name, seed, seconds, trace, device="cpu",
                           overrides=overrides(cell, limit, **traffic),
                           started=time.perf_counter())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=123456789012)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out, run = rehearse(args.workload, args.seconds, args.seed,
                        bool(args.trace))
    print(f"rehearsal of {args.workload} on the CPU at reduced width: "
          f"{out['attempted']} agents, {out['failed']} unfinished, "
          f"{run.rec.n_tokens} tokens, {run.engine.metrics['swaps']} swaps; "
          f"output check {'passed' if out['correct'] else 'FAILED'} "
          f"({out['checks']})")
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
