"""Write the record of the JAX engine's runs that the port is held to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/record_jax_api_runs.py

Serves ``chip_smoke.API_RUNS`` through the JAX package's ``AgentService``
on reduced granite-3-2b (vocab 512, float32, parameters from
``PRNGKey(0)``) on the CPU, runs the JAX launcher ``--backend engine`` at
each of ``chip_smoke.LAUNCHER_ARCHS``, serves ``chip_smoke.RING_RUN`` on
the JAX ``ServeEngine`` at reduced h2o-danube-1.8b (one layer) with its
window of 4096 kept, and writes what they give to ``tests/torch_api_jax_runs.json``: per
run the finish and JCT of every agent, each engine's counters and every
agent's events without token values; per launcher its ``jct:`` and
``completions:`` lines; for the ring run the completions, the clock, the
counters and every listener event without token values.

No API run's record depends on the arch: at the runs' cache of 512
tokens it is the same at every decoder-only arch the port serves, each at
its full vocabulary and its full-width window (checked with the JAX
package at reduced width; the prefix-cache runs' hashes of ``ids %
vocab`` hit alike at vocab 512 and at 32,000-128,256).  So phase 8 holds
llama2-7b and mixtral-8x7b to these runs.

The engine clock counts iterations: it depends on prompt lengths, token
budgets, the pool and the scheduler, not on the model's width, dtype or
sampled tokens.  So this record, made at reduced width, is what
``chip_smoke.py`` phase 7 requires of the port's full-width bf16 model on
the card, where JAX is not installed.  ``tests/test_torch_api.py``
regenerates it and requires the committed file unchanged.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 512
#: what made the record, stored in it
MADE_BY = ("the JAX package (repro) on the CPU: granite-3-2b "
           "reduced(vocab=512), float32, parameters from PRNGKey(0); the "
           "ring run on h2o-danube-1.8b reduced(vocab=512, n_layers=1, "
           "sliding_window=4096)")


def load_chip_smoke():
    """``chip_smoke.py`` as a module (it defines the runs)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_model():
    import jax

    from repro.configs import get_config
    from repro.models import Model

    model = Model(get_config("granite-3-2b").reduced(vocab=VOCAB))
    return model, model.init(jax.random.PRNGKey(0))


def jax_runs(smoke, model, params) -> dict:
    """Run name -> (record, agent handles) of the JAX engine."""
    from repro import api

    return {name: smoke.serve_api(api, model, params, run)
            for name, run in smoke.API_RUNS.items()}


def jax_launcher(smoke, arch: str) -> dict:
    """The ``jct:`` and ``completions:`` lines of the JAX launcher."""
    from repro.launch import serve

    argv = ["repro.launch.serve", "--backend", "engine", "--arch", arch]
    out = io.StringIO()
    with mock.patch.object(sys, "argv", argv), contextlib.redirect_stdout(
            out):
        serve.main()
    return smoke.launcher_lines(out.getvalue())


def jax_ring_run(smoke) -> dict:
    """``RING_RUN`` on the JAX engine: reduced width and one layer (vocab
    512, float32, parameters from ``PRNGKey(0)``), the arch's own window
    kept."""
    import jax

    from repro.configs import get_config
    from repro.core import InferenceSpec, agent_cost, make_scheduler
    from repro.engine import EngineAgent, ServeEngine
    from repro.models import Model

    full = get_config(smoke.RING_RUN["arch"])
    model = Model(full.reduced(vocab=VOCAB, n_layers=1,
                               sliding_window=full.sliding_window))
    pkg = dict(InferenceSpec=InferenceSpec, agent_cost=agent_cost,
               make_scheduler=make_scheduler, EngineAgent=EngineAgent,
               ServeEngine=ServeEngine)
    return smoke.serve_ring(pkg, model, model.init(jax.random.PRNGKey(0)))[0]


def build_record(smoke, runs: dict) -> dict:
    """The record, from ``jax_runs``' result, the JAX launcher and the JAX
    engine's ring run."""
    return {
        "made_by": MADE_BY,
        "runs": {name: rec for name, (rec, _) in runs.items()},
        "launcher": {arch: jax_launcher(smoke, arch)
                     for arch in smoke.LAUNCHER_ARCHS},
        "ring": jax_ring_run(smoke),
    }


def dumps(record: dict) -> str:
    """JSON with each innermost list (an event) on one line."""
    text = json.dumps(record, indent=1)
    return re.sub(r"\[\n\s+([^\[\]{}]*?)\n\s+\]",
                  lambda m: "[" + " ".join(m.group(1).split()) + "]",
                  text) + "\n"


def main() -> None:
    smoke = load_chip_smoke()
    model, params = jax_model()
    record = build_record(smoke, jax_runs(smoke, model, params))
    smoke.API_RECORD.write_text(dumps(record))
    print(f"wrote {smoke.API_RECORD.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
