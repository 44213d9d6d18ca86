"""Run one cell of the benchmark on the card and print its result line.

    python3 bench/run.py --workload granite-3-2b.agents-open --seed 7 \\
        --seconds 50 --trace 0

Run from the root of a checkout, with nothing installed: the program is
``src/repro_torch``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the output
check compared, beside its limit); the same numbers close standard error.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics.  Without a CUDA card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded when the window has
closed, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the driver's cache of JIT-compiled kernels, at a fixed path inside the
#: checkout (the port builds its own kernels with nvcc into
#: build/torch_kernels, and uses neither torch.utils.cpp_extension nor
#: Triton), so that only a checkout's first run builds
CACHES = {"CUDA_CACHE_PATH": "build/bench/cuda_cache"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def main(argv=None) -> int:
    args = parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import torch

    import harness

    cell = harness.cell_of(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out, run = harness.execute(args.workload, args.seed, args.seconds,
                               bool(args.trace), started=STARTED)
    harness.log(f"card: {card_line()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    found = forbidden_modules()
    if found:
        print(f"loaded in the reporting process: {found}", file=sys.stderr)
        return 3
    med, top = run.lag()
    harness.log(f"generator lag: median {med} s, largest {top} s; "
                f"window {run.window_end - run.t0} s, drain "
                f"{run.drain_end - run.window_end} s, setup {run.setup_s} s "
                f"({run.phases})")
    m = run.engine.metrics
    harness.log(f"engine: {m['decode_steps']} decode steps in "
                f"{m['windows']} windows, {m['prefills']} prefills, "
                f"{m['swaps']} swaps; in the window {run.window_tokens} tokens, "
                f"{run.window_decode_steps} decode steps; end to end "
                f"{run.end_to_end()}")
    if run.tracer is not None and run.tracer.device:
        harness.log(f"trace: {run.tracer.device}, busy time inside engine "
                    f"steps {run.tracer.aligned}, profiler stop "
                    f"{run.tracer.stop_s} s")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": run.memory_peak}
    if args.trace:
        device.update(run.tracer.device)
    checks = out.pop("checks")
    line = {**out, "device": device, "checks": checks}
    for name, c in checks.items():
        harness.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
