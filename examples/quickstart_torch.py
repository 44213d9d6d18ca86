"""Quickstart for the port's unified serving API
(``repro_torch.api.AgentService``; the PyTorch counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds a reduced granite-family model on ``--device`` (the CUDA card unless
another device is named; with none named and no CUDA device it raises),
wraps it in an ``AgentService`` over the port's continuous-batching engine,
and submits two competing agents (an elephant and a mouse) as
backend-agnostic ``AgentSpec``s.  The service resolves the scheduler by
registry name, streams lifecycle events (admissions, per-token generation,
completions) to the agent handles, and shows selective pampering: the
mouse (earlier GPS virtual finish) completes long before the elephant even
though it was submitted second.

The completion iterations and the engine counters equal the JAX
example's: the engine clock counts iterations.  The mouse's tokens are
the model's, and its weights are torch's draws from seed 0, not JAX's.
"""

from __future__ import annotations

import argparse

from repro_torch.api import AgentService, AgentSpec
from repro_torch.configs import get_config
from repro_torch.core import InferenceSpec
from repro_torch.device import resolve_device
from repro_torch.models import Model

VOCAB = 256


def make_spec(n_inferences, prompt_len, decode_len, name):
    return AgentSpec(
        stages=[[InferenceSpec(prompt_len, decode_len)] * n_inferences],
        name=name,
    )


def build_model(device):
    """Reduced granite-3-2b (vocabulary 256) on ``device``, with its
    parameters from seed 0."""
    model = Model(get_config("granite-3-2b").reduced(vocab=VOCAB),
                  device=device)
    return model, model.init(seed=0)


def serve(model, params):
    """The elephant and the mouse through ``AgentService.engine``; returns
    the drained result and the two handles."""
    service = AgentService.engine(
        model, params, "justitia",
        pool_tokens=512, block_size=16, max_batch=2, cache_len=256,
    )
    elephant = service.submit(
        make_spec(6, prompt_len=100, decode_len=100, name="elephant")
    )
    mouse = service.submit(
        make_spec(1, prompt_len=16, decode_len=8, name="mouse")
    )
    return service.drain(), elephant, mouse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device of the model (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    model, params = build_model(resolve_device(args.device))
    result, elephant, mouse = serve(model, params)
    print("agent completion iterations:", result.finish)
    print("mouse generated tokens:", mouse.tokens)
    print("engine metrics:", result.metrics)
    assert mouse.finish < elephant.finish, "mouse should finish first"
    print("OK: the mouse was pampered past the elephant "
          "(earlier GPS virtual finish time)")


if __name__ == "__main__":
    main()
