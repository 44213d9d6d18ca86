"""The port's four examples (``examples/*_torch.py``) against the JAX
examples' record (``tests/torch_examples_jax_runs.json``), on the CPU with
``--device cpu`` and the kernels' plain versions.

* serve_agents: every flag set of ``chip_smoke.EXAMPLE_SETS``.  The
  closed-loop sets fit no predictor and run through ``main`` as users start
  them.  The other sets fit the per-class MLPs, whose initial weights are
  torch's draws in the port, so there the JAX example's fitted predictor is
  carried across (``predictor_from_jax``) and handed to the example's own
  ``build_specs``.  Every printed line but the wall seconds', the gated
  ``backend metrics:`` values (``chip_smoke.metrics_subset``: phase 7's
  counters, and ``sorts``, ``key_evals``, ``host_syncs``, ``windows`` and
  ``admission_deferrals``, which equal the JAX engine's too, with the
  fleet's keys) and, where the record holds them, every agent's events
  must be equal.  The port's own fit is held to JAX's only to the
  tolerance below: the two fits start from different weights.
* quickstart: the completions and counters exactly from the port's own
  parameters, and every sampled token from JAX's parameters carried
  across at float32.
* fairness_demo: the table exactly.
* train_small: the first 10 steps from JAX's parameters within
  ``TRAIN_RTOL``; its checkpoint read by JAX's ``restore_checkpoint``.
"""

import contextlib
import io
import json
import re
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.predictor import AgentCostPredictor as JaxPredictor
from repro.training import restore_checkpoint as jax_restore
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.params import params_from_jax, predictor_from_jax
from repro_torch.predictor.service import relative_error
from repro_torch.training import init_adamw, restore_checkpoint
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent


def _load(name: str, path: Path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
RECORD = json.loads(smoke.EXAMPLES_RECORD.read_text())
serve_agents = smoke.load_example("serve_agents_torch")
quickstart = smoke.load_example("quickstart_torch")
fairness_demo = smoke.load_example("fairness_demo_torch")
train_small = smoke.load_example("train_small_torch")
#: the JAX predictor carried across predicts each cost within this relative
#: bound of JAX's (measured on the CPU: 9.4e-7, float32 rounding)
BRIDGED_COST_RTOL = 1e-5
#: the port's own fit against JAX's: each agent's cost within this factor
#: of the record's, and the mean relative error against the true costs at
#: most this many points above JAX's.  The fits start from different
#: weights and 60 samples a class; measured on the CPU: cost ratios
#: 0.248-1.86, mean errors 61.3 % (port) and 77.8 % (JAX), while JAX's own
#: costs lie within a factor of 2.8 of the true ones
OWN_COST_FACTOR = 5.0
OWN_ERROR_MARGIN = 20.0
#: train_small's loss, grad norm and lr against JAX's over 10 steps from
#: the same parameters (measured on the CPU: 2.4e-7)
TRAIN_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def printed(fn, *args):
    """``fn(*args)``'s return value and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        value = fn(*args)
    return value, out.getvalue()


@pytest.fixture(scope="module")
def jax_predictor():
    """The JAX example's predictor: its history (the port's sampler is a
    verbatim copy) fitted as the JAX example fits it."""
    samples = serve_agents.predictor_history(np.random.default_rng(0))
    pred = JaxPredictor(max_features=48)
    pred.fit(samples, epochs=300)
    return pred


def serve_set(name: str, fit=None):
    """serve_agents' flag set ``name`` on the CPU through the example's own
    functions (``fit`` for ``build_specs``); returns the specs, the service
    and what it printed, as the record holds it."""
    args = serve_agents.parse_args(RECORD["serve_agents"][name]["argv"]
                                   + ["--device", "cpu"])

    def run():
        specs = serve_agents.build_specs(
            args, "cpu", fit=fit or serve_agents.fit_predictor)
        service = serve_agents.build_service(args, "cpu")
        serve_agents.serve(args, service, specs)
        return specs, service

    (specs, service), out = printed(run)
    return specs, service, smoke.serve_agents_output(out)


def assert_equals_record(name: str, service, got: dict) -> None:
    rec = RECORD["serve_agents"][name]
    assert got["lines"] == rec["lines"]
    assert got["metrics"] == rec["metrics"]
    if "events" in rec:
        assert smoke.handle_events(service.handles.values()) == rec["events"]


# -------------------------------------------------------------- serve_agents


PREDICTOR_SETS = [n for n, r in RECORD["serve_agents"].items() if r["costs"]]
CLOSED_SETS = [n for n, r in RECORD["serve_agents"].items()
               if not r["costs"]]


@pytest.mark.parametrize("name", PREDICTOR_SETS)
def test_serve_agents_with_the_jax_predictor_equals_the_record(
        name, jax_predictor):
    specs, service, got = serve_set(
        name, fit=lambda samples, device: predictor_from_jax(jax_predictor,
                                                             device))
    want = [c for _, _, c in RECORD["serve_agents"][name]["costs"]]
    np.testing.assert_allclose([s.predicted_cost for s in specs], want,
                               rtol=BRIDGED_COST_RTOL, atol=0)
    assert_equals_record(name, service, got)


@pytest.mark.parametrize("name", CLOSED_SETS)
def test_serve_agents_closed_loop_main_equals_the_record(name):
    """The sets that fit no predictor, through ``main`` as users start
    them (``--device cpu``)."""
    rec = RECORD["serve_agents"][name]
    result, out = printed(serve_agents.main, rec["argv"] + ["--device",
                                                            "cpu"])
    got = smoke.serve_agents_output(out)
    assert got["lines"] == rec["lines"]
    assert got["metrics"] == rec["metrics"]
    assert result.backend == "engine"


def test_recorded_costs_serve_the_record():
    """``chip_smoke.RecordedCosts`` (the card's stand-in for JAX's
    predictor) gives the record's costs, and serving them gives the
    record's output."""
    costs = RECORD["serve_agents"]["default"]["costs"]
    specs, service, got = serve_set(
        "default", fit=lambda samples, device: smoke.RecordedCosts(costs))
    assert [s.predicted_cost for s in specs] == [c for _, _, c in costs]
    assert_equals_record("default", service, got)


def test_own_predictor_within_tolerance_of_the_record():
    """The port's own fit (torch's initial weights) against JAX's: each
    cost within ``OWN_COST_FACTOR`` of the record's, and as good against
    the true costs within ``OWN_ERROR_MARGIN`` points."""
    args = serve_agents.parse_args(["--device", "cpu"])
    specs, _ = printed(serve_agents.build_specs, args, "cpu")
    got = np.array([s.predicted_cost for s in specs])
    want = np.array([c for _, _, c in
                     RECORD["serve_agents"]["default"]["costs"]])
    truth = np.array([s.true_cost for s in specs])
    ratio = got / want
    assert ratio.min() > 1 / OWN_COST_FACTOR and ratio.max() < \
        OWN_COST_FACTOR, ratio
    assert relative_error(got, truth) <= (relative_error(want, truth)
                                          + OWN_ERROR_MARGIN)


def test_serve_agents_takes_the_jax_flags():
    """The port's parser takes every flag of the JAX example's, plus
    ``--device`` (the flags of each usage line)."""
    jax_ex = _load("jax_serve_agents", ROOT / "examples" / "serve_agents.py")
    flags = {}
    for name, main in (("jax", jax_ex.main),
                       ("port", serve_agents.parse_args)):
        out = io.StringIO()
        with pytest.raises(SystemExit), contextlib.redirect_stdout(out), \
                mock.patch("sys.argv", ["serve_agents", "--help"]):
            main()
        usage = out.getvalue().split("\n\n")[0]
        flags[name] = set(re.findall(r"\[(--[a-z][a-z-]*)", usage))
    assert flags["port"] == flags["jax"] | {"--device"}


@pytest.mark.parametrize("argv", [
    ["--chaos", "3"],
    ["--fleet-workers", "2"],
    ["--steal-threshold", "1.5"],
    ["--watchdog-timeout", "1"],
    ["--replicas", "2", "--steal-interval", "1"],
    ["--closed-loop-classes", "chat"],
], ids=lambda a: a[-2])
def test_serve_agents_refuses_what_the_jax_example_refuses(argv):
    with pytest.raises(SystemExit) as err, \
            contextlib.redirect_stderr(io.StringIO()):
        serve_agents.parse_args(argv + ["--device", "cpu"])
    assert err.value.code == 2


# -------------------------------------------------- quickstart, fairness


def test_quickstart_main_equals_the_record():
    """The port's own parameters: completions, engine counters and the
    pampering line equal the JAX example's (the tokens are the weights')."""
    _, out = printed(quickstart.main, ["--device", "cpu"])
    got, want = out.splitlines(), RECORD["quickstart"]["lines"]
    assert len(got) == len(want) == 4
    for i in (0, 2, 3):
        assert got[i] == want[i]
    assert got[1].startswith("mouse generated tokens: ")


def test_quickstart_tokens_equal_jax_from_its_parameters():
    """JAX's parameters carried across at float32: every sampled token of
    both agents, and every printed line, equal the JAX example's."""
    jcfg = jax_get_config("granite-3-2b").reduced(vocab=quickstart.VOCAB)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = Model(get_config("granite-3-2b").reduced(vocab=quickstart.VOCAB),
                  device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    (result, elephant, mouse), _ = printed(quickstart.serve, model, params)
    rec = RECORD["quickstart"]
    assert {str(h.agent_id): [int(t) for t in h.tokens]
            for h in (elephant, mouse)} == rec["tokens"]
    assert (f"mouse generated tokens: {mouse.tokens}" == rec["lines"][1])
    assert f"agent completion iterations: {result.finish}" == rec["lines"][0]


def test_fairness_demo_equals_the_record():
    _, out = printed(fairness_demo.main)
    assert out.splitlines() == RECORD["fairness_demo"]["lines"]


# ------------------------------------------------------------ train_small


def jax_train_params():
    args = train_small.parse_args(["--device", "cpu"])
    cfg = jax_get_config(args.arch).reduced(
        vocab=train_small.VOCAB, n_layers=2, d_model=256, d_ff=512,
        n_heads=4, n_kv_heads=2, head_dim=64)
    return JaxModel(cfg).init(jax.random.PRNGKey(0))


def test_train_small_follows_jax_from_its_parameters():
    """The example's own model, step and data, from JAX's parameters: the
    first 10 steps' loss, grad norm and lr within ``TRAIN_RTOL``."""
    args = train_small.parse_args(["--device", "cpu"])
    _, _, _, step, data = train_small.build(args, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jax_train_params()),
                             "cpu")
    opt = init_adamw(params)
    rec = RECORD["train_small"]
    got = {"loss": [], "grad_norm": [], "lr": []}
    for _ in range(rec["steps"]):
        batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
        params, opt, metrics = step(params, opt, batch)
        for k in got:
            got[k].append(float(metrics[k]))
    for k, values in got.items():
        np.testing.assert_allclose(values, rec[k], rtol=TRAIN_RTOL, atol=0)
    assert rec["loss"][-1] < rec["loss"][0]


def test_train_small_checkpoint_crosses_to_jax(tmp_path):
    """``main`` on the CPU writes a checkpoint that JAX's
    ``restore_checkpoint`` reads leaf for leaf, at the step it names."""
    path = str(tmp_path / "ckpt.msgpack")
    _, out = printed(train_small.main, ["--device", "cpu", "--steps", "3",
                                        "--ckpt", path])
    assert f"checkpoint round-trip OK at step 3 -> {path}" in out
    args = train_small.parse_args(["--device", "cpu"])
    _, like, _, _, _ = train_small.build(args, "cpu")
    port, step = restore_checkpoint(path, {"params": like})
    jax_tree, jax_step = jax_restore(path, {"params": jax_train_params()})
    assert step == jax_step == 3
    got = tree_leaves(port["params"])
    want = jax.tree.leaves(jax_tree["params"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert any(not torch.equal(a, b) for a, b in zip(got, tree_leaves(like)))


# ----------------------------------------------------------------- devices


@pytest.mark.parametrize("example", ["quickstart", "serve_agents",
                                     "train_small"])
def test_examples_raise_without_a_device(example):
    """With no ``--device`` and no CUDA device, each example but
    fairness_demo (the sim only) raises before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    main = {"quickstart": quickstart.main, "serve_agents": serve_agents.main,
            "train_small": train_small.main}[example]
    with pytest.raises(RuntimeError, match="device='cpu'"), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        main([])
    assert out.getvalue() == ""


def test_every_example_has_a_port():
    names = {p.stem for p in (ROOT / "examples").glob("*.py")}
    jax_examples = {n for n in names if not n.endswith("_torch")}
    assert {n + "_torch" for n in jax_examples} == names - jax_examples
    assert len(jax_examples) == 4
