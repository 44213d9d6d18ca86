"""The port's agent cost predictor against the JAX package's (CPU, float32).

Inputs come from numpy seeds; initial parameters from the JAX inits through
``params_from_jax`` (the port's own draws differ from JAX's).

* ``TfidfVectorizer`` (a verbatim copy) transforms equally.
* ``mlp_apply`` within 1e-6; 1 and 5 ``_adam_step``s within 1e-6.
* ``MlpCostModel.train`` from JAX's initial parameters (the port's
  ``init_mlp_params`` monkeypatched to hand back the bridged ones): on the
  quadratic data of ``tests/test_predictor.py`` and on the SC class of its
  Table-1 setting, both stop at the same step and predict within 1e-4
  relative.  On the EV class neither stops early and the trajectories part:
  Adam divides by ``sqrt(v_hat) + 1e-8``, which magnifies one-ulp
  differences in near-zero gradients (measured on the CPU: parameters apart
  by up to 0.020 by step 50, final costs by up to 0.79 %), so the EV costs
  are held within 2e-2 relative and the held-out relative error within 1
  percentage point of JAX's.
* A fitted JAX ``AgentCostPredictor`` carried across
  (``predictor_from_jax``) predicts within 1e-5 relative, and
  ``specs_from_classes(predictor=)`` gives the JAX package's specs.
* ``encoder_apply`` and one ``_sgd_step`` of the heavy baseline within
  1e-5 (``_hash_tokens`` agrees within one process only, as it hashes with
  Python's salted ``hash()`` in both packages).
* The port's own versions of ``tests/test_predictor.py``'s learning,
  clip-band and end-to-end tests, on the port's own initial draws.
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.workload import specs_from_classes as jax_specs
from repro.predictor import AgentCostPredictor as JaxPredictor
from repro.predictor import TfidfVectorizer as JaxTfidf
from repro.predictor import heavy as jheavy
from repro.predictor import mlp as jmlp
from repro.workloads import sample_agent
from repro_torch.api.workload import specs_from_classes
from repro_torch.models.params import params_from_jax, predictor_from_jax
from repro_torch.predictor import (
    AgentCostPredictor,
    HeavyPredictor,
    MlpCostModel,
    TfidfVectorizer,
    relative_error,
)
from repro_torch.predictor import heavy as theavy
from repro_torch.predictor import mlp as tmlp

CLASSES = ("EV", "SC")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def table1_setting():
    """``tests/test_predictor.py``'s Table-1 setting: per class 100
    training and 40 held-out agents, EV drawn first, from one seed."""
    rng = np.random.default_rng(0)
    samples, test = {}, {}
    for cls in CLASSES:
        tr = [sample_agent(rng, cls) for _ in range(100)]
        te = [sample_agent(rng, cls) for _ in range(40)]
        samples[cls] = ([a.prompt for a in tr], [a.true_cost for a in tr])
        test[cls] = ([a.prompt for a in te],
                     np.array([a.true_cost for a in te]))
    return samples, test


def quadratic_data():
    """``tests/test_predictor.py``'s quadratic cost: one signal feature,
    one noise feature; 150 training and 50 held-out rows."""
    rng = np.random.default_rng(0)
    z = rng.uniform(0, 1, 200)
    x = np.stack([z, rng.normal(size=200)], axis=1)
    return x, (5 + 20 * z) ** 2


def class_data(cls):
    """One class's TF-IDF features (``max_features`` 64) and costs, for
    training and held out."""
    samples, test = table1_setting()
    vec = JaxTfidf(max_features=64)
    x = vec.fit_transform(list(samples[cls][0]))
    return (x, np.asarray(samples[cls][1], np.float64),
            vec.transform(list(test[cls][0])), test[cls][1])


def bridged_mlp(in_dim=24, widths=(24, 12, 8), seed=0):
    jp = jmlp.init_mlp_params(jax.random.PRNGKey(seed), in_dim, list(widths))
    return jp, params_from_jax(jax.device_get(jp), "cpu")


def assert_tree_close(port, ref, atol, rtol=0.0):
    for lp, lj in zip(port, ref):
        for k in ("w", "b"):
            np.testing.assert_allclose(lp[k].numpy(), np.asarray(lj[k]),
                                       atol=atol, rtol=rtol)


# ------------------------------------------------------------------ tfidf


def test_tfidf_transforms_equal():
    samples, test = table1_setting()
    for cls in CLASSES:
        port, ref = TfidfVectorizer(max_features=64), JaxTfidf(max_features=64)
        np.testing.assert_array_equal(port.fit_transform(samples[cls][0]),
                                      ref.fit_transform(samples[cls][0]))
        np.testing.assert_array_equal(port.transform(test[cls][0]),
                                      ref.transform(test[cls][0]))
        assert port.state_dict() == ref.state_dict()


# -------------------------------------------------------------------- mlp


def test_mlp_apply_matches_jax():
    jp, tp = bridged_mlp()
    x = np.random.default_rng(3).normal(size=(32, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tmlp.mlp_apply(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jmlp.mlp_apply(jp, jnp.asarray(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_steps", [1, 5])
def test_adam_steps_match_jax(n_steps):
    jp, tp = bridged_mlp()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 24)).astype(np.float32)
    y = rng.normal(size=40).astype(np.float32)
    jopt = (jax.tree.map(jnp.zeros_like, jp), jax.tree.map(jnp.zeros_like, jp))
    topt = tuple([{k: torch.zeros_like(t) for k, t in layer.items()}
                  for layer in tp] for _ in range(2))
    for step in range(1, n_steps + 1):
        jp, jopt = jmlp._adam_step(jp, jopt, jnp.asarray(x), jnp.asarray(y),
                                   step, 3e-3, 3e-4)
        tp, topt = tmlp._adam_step(tp, topt, torch.from_numpy(x),
                                   torch.from_numpy(y), step, 3e-3, 3e-4)
    assert_tree_close(tp, jp, atol=1e-6)
    for port, ref in zip(topt, jopt):
        assert_tree_close(port, ref, atol=1e-6)


def train_both(monkeypatch, x, cost, **kw):
    """``MlpCostModel.train`` in both packages from JAX's initial
    parameters; returns both models and the last Adam step each took."""
    jax_init, jax_step = jmlp.init_mlp_params, jmlp._adam_step
    port_step = tmlp._adam_step
    seen, steps = {}, {"jax": 0, "port": 0}

    def capture_init(key, in_dim, widths):
        seen["params"] = jax_init(key, in_dim, widths)
        return seen["params"]

    def count(name, fn):
        def step(*args, **kwargs):
            steps[name] = args[4]
            return fn(*args, **kwargs)
        return step

    monkeypatch.setattr(jmlp, "init_mlp_params", capture_init)
    monkeypatch.setattr(jmlp, "_adam_step", count("jax", jax_step))
    monkeypatch.setattr(
        tmlp, "init_mlp_params",
        lambda gen, in_dim, widths, device=None: params_from_jax(
            jax.device_get(seen["params"]), device))
    monkeypatch.setattr(tmlp, "_adam_step", count("port", port_step))
    ref = jmlp.MlpCostModel.train(x, cost, **kw)
    port = MlpCostModel.train(x, cost, device="cpu", **kw)
    return ref, port, steps


@pytest.mark.parametrize("case", ["quadratic", "SC"])
def test_training_stops_with_jax(monkeypatch, case):
    if case == "quadratic":
        x, cost = quadratic_data()
        x, cost, x_test = x[:150], cost[:150], x[150:]
    else:
        x, cost, x_test, _ = class_data(case)
    ref, port, steps = train_both(monkeypatch, x, cost)
    assert steps["port"] == steps["jax"] < 800, steps
    for a, b in ((port.x_mean, ref.x_mean), (port.x_std, ref.x_std)):
        np.testing.assert_array_equal(a, b)
    assert (port.y_mean, port.y_lo, port.y_hi) == (ref.y_mean, ref.y_lo,
                                                   ref.y_hi)
    np.testing.assert_allclose(port.predict(x_test), ref.predict(x_test),
                               rtol=1e-4, atol=0)


def test_training_ev_within_adam_tolerance(monkeypatch):
    x, cost, x_test, truth = class_data("EV")
    ref, port, steps = train_both(monkeypatch, x, cost)
    assert steps == {"jax": 800, "port": 800}
    pj, pt = ref.predict(x_test), port.predict(x_test)
    np.testing.assert_allclose(pt, pj, rtol=2e-2, atol=0)
    assert abs(relative_error(pt, truth) - relative_error(pj, truth)) < 1.0


# -------------------------------------------------------- the whole service


@pytest.fixture(scope="module")
def jax_fitted():
    samples, test = table1_setting()
    ref = JaxPredictor(max_features=64)
    ref.fit(samples)
    return ref, test


def test_bridged_predictor_matches_jax(jax_fitted):
    ref, test = jax_fitted
    port = predictor_from_jax(ref, "cpu")
    assert port.total_train_time_s == ref.total_train_time_s
    for cls, (prompts, _) in test.items():
        np.testing.assert_allclose(port.predict_batch(cls, prompts),
                                   ref.predict_batch(cls, prompts),
                                   rtol=1e-5, atol=0)
        assert port.predict(cls, prompts[0]) == pytest.approx(
            ref.predict(cls, prompts[0]), rel=1e-5)


def plain(obj):
    """Enums (each package has its own classes) as their values."""
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def test_specs_from_classes_with_predictor_equal_jax(jax_fitted):
    ref, _ = jax_fitted
    port = predictor_from_jax(ref, "cpu")
    got = specs_from_classes(np.random.default_rng(11), 12, 20.0,
                             classes=CLASSES, predictor=port)
    want = jax_specs(np.random.default_rng(11), 12, 20.0, classes=CLASSES,
                     predictor=ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        da, db = plain(dataclasses.asdict(a)), plain(dataclasses.asdict(b))
        assert da.pop("predicted_cost") == pytest.approx(
            db.pop("predicted_cost"), rel=1e-5)
        assert da == db


# ------------------------------------------------------------------ heavy


@pytest.fixture(scope="module")
def encoder_pair():
    jp = jheavy.init_encoder_params(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), "cpu")


def heavy_batch(n=6):
    samples, _ = table1_setting()
    prompts = samples["EV"][0][:n] + samples["SC"][0][:n]
    ids = np.stack([jheavy._hash_tokens(p) for p in prompts])
    y = np.log1p(np.asarray(samples["EV"][1][:n] + samples["SC"][1][:n],
                            np.float32))
    return prompts, ids, y


def test_hash_tokens_equal_within_a_process():
    prompts, ids, _ = heavy_batch()
    np.testing.assert_array_equal(
        np.stack([theavy._hash_tokens(p) for p in prompts]), ids)


def test_encoder_apply_matches_jax(encoder_pair):
    jp, tp = encoder_pair
    _, ids, _ = heavy_batch()
    np.testing.assert_allclose(
        theavy.encoder_apply(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(jheavy.encoder_apply(jp, jnp.asarray(ids))),
        atol=1e-5, rtol=0)


def test_sgd_step_matches_jax(encoder_pair):
    jp, tp = encoder_pair
    _, ids, y = heavy_batch()
    jnew = jax.device_get(jheavy._sgd_step(jp, jnp.asarray(ids),
                                           jnp.asarray(y), jnp.float32(3e-4)))
    tnew = theavy._sgd_step(tp, torch.from_numpy(ids), torch.from_numpy(y),
                            3e-4)
    pairs = [(tnew[k], jnew[k]) for k in ("embed", "pos", "head")]
    pairs += [(tl[k], jl[k]) for tl, jl in zip(tnew["layers"], jnew["layers"])
              for k in tl]
    for port, ref in pairs:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_heavy_predictor_trains_and_predicts():
    prompts, _, y = heavy_batch()
    pred = HeavyPredictor.train(prompts, np.expm1(y), epochs=2, batch=4,
                                device="cpu")
    batch = pred.predict_batch(prompts)
    assert batch.shape == (len(prompts),) and np.isfinite(batch).all()
    assert pred.predict(prompts[0]) == pytest.approx(float(batch[0]),
                                                     rel=1e-5)


# ------------------------------------ the port's own tests/test_predictor.py


def test_mlp_learns_synthetic_quadratic():
    x, cost = quadratic_data()
    m = MlpCostModel.train(x[:150], cost[:150], device="cpu")
    err = relative_error(m.predict(x[150:]), cost[150:])
    base = relative_error(np.full(50, cost[:150].mean()), cost[150:])
    assert err < base / 2
    assert err < 25.0


def test_mlp_prediction_clipped_to_train_band():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(100, 3))
    cost = np.exp(rng.normal(10, 0.3, 100))
    m = MlpCostModel.train(x, cost, epochs=50, device="cpu")
    wild = m.predict(rng.normal(scale=50, size=(20, 3)))
    assert wild.max() <= cost.max() * 1.3 + 1
    assert wild.min() >= cost.min() * 0.7 - 1


def test_end_to_end_predictor_accuracy():
    samples, test = table1_setting()
    pred = AgentCostPredictor(max_features=64, device="cpu")
    pred.fit(samples)
    for cls, (prompts, truth) in test.items():
        err = relative_error(pred.predict_batch(cls, prompts), truth)
        assert err < 120.0, f"{cls}: {err}"
    c = pred.predict("EV", test["EV"][0][0])
    assert np.isfinite(c) and c > 0
