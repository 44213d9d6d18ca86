"""Write the record of the JAX examples that the port's examples are held to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/record_jax_examples.py

Runs the four JAX examples (``examples/{serve_agents,quickstart,
fairness_demo,train_small}.py``) on the CPU through their ``main`` with a
patched ``argv`` and writes what they give to
``tests/torch_examples_jax_runs.json``:

* ``serve_agents``: per flag set of ``chip_smoke.EXAMPLE_SETS`` the printed
  lines but the wall seconds' (``lines``), the ``backend metrics:`` values
  that are held to the record (``metrics``, ``chip_smoke.metrics_subset``),
  each agent's predicted cost as ``[class, prompt digest, cost]`` in the
  order the predictor was asked (``costs``; null for the closed-loop sets,
  which fit no predictor) and, for ``chip_smoke.EXAMPLE_EVENT_SETS``,
  every agent's events without token values (``events``);
* ``quickstart``: its printed lines and every agent's sampled tokens;
* ``fairness_demo``: its printed table;
* ``train_small``: the loss, grad norm and learning rate of its first 10
  steps at the default 200-step schedule (the run stops there).

The ``chaos`` set's seed is 3: replica 1 crashes at t=11.1 s while it
serves agent 2, well before the drain.  Its ``replica_failures`` is 0
all the same, at this seed as at every seed from 0 to 399 at the
example's defaults: the engine backend's ``run`` ceils its horizon to the
next iteration, so a crashed child stands up to one iteration past its
crash time, and at the watchdog's last probe (crash + 4.2 s) it lags by
less than the 4.2 s budget.  The JAX fleet never declares the crash and
drains the crashed child as a live one; the port's fleet, a verbatim copy,
does the same, and the record holds that.

The engine clock counts iterations: the record, made at reduced width on
the CPU, is what ``chip_smoke.py`` phase 13 requires of the port's
examples on the card and of full-width h2o-danube-1.8b served with the
record's costs.  ``tests/test_torch_examples_record.py`` regenerates it
and requires the committed file unchanged.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import re
import sys
import tempfile
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
#: what made the record, stored in it
MADE_BY = ("the JAX package (repro) on the CPU: examples/serve_agents.py, "
           "quickstart.py, fairness_demo.py and train_small.py at their "
           "own settings, through main() with a patched argv")
#: train_small's steps that the record holds
TRAIN_STEPS = 10


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv: list) -> str:
    """``mod.main()`` with ``argv``; returns what it printed."""
    out = io.StringIO()
    with mock.patch.object(sys, "argv", [mod.__name__, *argv]), \
            contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


@contextlib.contextmanager
def drained():
    """Patches ``AgentService.drain``; yields the list of services it
    drains."""
    from repro.api.service import AgentService

    real, seen = AgentService.drain, []

    def drain(service):
        seen.append(service)
        return real(service)

    with mock.patch.object(AgentService, "drain", drain):
        yield seen


def serve_agents(smoke) -> dict:
    from repro.predictor.service import AgentCostPredictor

    ex = load("serve_agents", ROOT / "examples" / "serve_agents.py")
    real = AgentCostPredictor.predict
    out = {}
    for name, argv in smoke.EXAMPLE_SETS.items():
        costs = []

        def predict(self, cls, prompt):
            cost = real(self, cls, prompt)
            costs.append([cls, smoke.prompt_digest(prompt), float(cost)])
            return cost

        with mock.patch.object(AgentCostPredictor, "predict", predict), \
                drained() as services:
            text = run_main(ex, argv)
        rec = {"argv": argv, **smoke.serve_agents_output(text),
               "costs": costs or None}
        if name in smoke.EXAMPLE_EVENT_SETS:
            rec["events"] = smoke.handle_events(services[0].handles.values())
        out[name] = rec
    return out


def quickstart() -> dict:
    ex = load("quickstart", ROOT / "examples" / "quickstart.py")
    with drained() as services:
        text = run_main(ex, [])
    return {"lines": text.splitlines(),
            "tokens": {str(h.agent_id): [int(t) for t in h.tokens]
                       for h in services[0].handles.values()}}


def fairness_demo() -> dict:
    ex = load("fairness_demo", ROOT / "examples" / "fairness_demo.py")
    return {"lines": run_main(ex, []).splitlines()}


class _Enough(Exception):
    """Raised once the train step has run ``TRAIN_STEPS`` times."""


def train_small() -> dict:
    """The first ``TRAIN_STEPS`` steps' metrics: ``jax.jit`` is wrapped (in
    the example's namespace only) so that each step's metrics are read,
    and the run is stopped after the last one."""
    import jax

    ex = load("train_small", ROOT / "examples" / "train_small.py")
    rows = []

    class Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn):
            step = jax.jit(fn)

            def run(*args):
                params, opt, metrics = step(*args)
                rows.append({k: float(metrics[k])
                             for k in ("loss", "grad_norm", "lr")})
                if len(rows) == TRAIN_STEPS:
                    raise _Enough
                return params, opt, metrics

            return run

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(ex, "jax", Jax()):
        try:
            run_main(ex, ["--ckpt", str(Path(tmp) / "ckpt.msgpack")])
        except _Enough:
            pass
    return {"steps": TRAIN_STEPS,
            **{k: [r[k] for r in rows] for k in ("loss", "grad_norm", "lr")}}


def build_record(smoke) -> dict:
    return {
        "made_by": MADE_BY,
        "serve_agents": serve_agents(smoke),
        "quickstart": quickstart(),
        "fairness_demo": fairness_demo(),
        "train_small": train_small(),
    }


def dumps(record: dict) -> str:
    """JSON with each innermost list (an event, a cost) on one line."""
    text = json.dumps(record, indent=1)
    return re.sub(r"\[\n\s+([^\[\]{}]*?)\n\s+\]",
                  lambda m: json.dumps(json.loads(f"[{m.group(1)}]")),
                  text) + "\n"


def main() -> None:
    smoke = load("chip_smoke", ROOT / "chip_smoke.py")
    smoke.EXAMPLES_RECORD.write_text(dumps(build_record(smoke)))
    print(f"wrote {smoke.EXAMPLES_RECORD.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
