"""The decoder-only configs of the port against the JAX package's (CPU).

* Every config module the port copies (``llama2_7b_paper``,
  ``llama3_2_3b``, ``starcoder2_7b``, ``h2o_danube_1_8b``,
  ``mixtral_8x7b``, ``dbrx_132b``, and since the last families' slice
  ``whisper_tiny``, ``llava_next_34b``, ``zamba2_2_7b``) equals the JAX one
  field by field, its ``LONG_CONTEXT_OVERRIDES`` too (whisper skips
  long_500k in both), and the registry holds every arch of the reference
  under its id, in its order; ``ASSIGNED_ARCHS``, ``supports_shape`` and
  the long_500k refusal's message equal the JAX registry's.
* Reduced llama2-7b, llama3.2-3b, starcoder2-7b and h2o-danube-1.8b at
  float32 with bridged parameters, keeping each arch's real ratio of q
  heads to kv heads (1, 3, 9 and 4): prefill and decode logits within
  1e-5 of JAX's, ``kv_pos`` equal and the valid cache rows within 2e-5
  (the tolerances of ``tests/test_torch_model.py``); the engine exact
  against the JAX engine: completions, clock, every counter, every event
  and every sampled token.
* The record of ``tests/torch_api_jax_runs.json`` holds at llama2-7b and
  mixtral-8x7b in the runs ``chip_smoke.py`` phase 8 serves them in, and
  ``service_for_backend`` serves every new decoder-only arch and
  llava-next-34b.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config
from repro.configs import supports_shape as jax_supports_shape
from repro.models import Model as JaxModel
from repro_torch import api
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, supports_shape
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.models.params import params_from_jax
from test_torch_api import RECORD, smoke
from test_torch_engine import synth_agents
from test_torch_prefix import (
    VOCAB,
    _one_torch_thread,  # noqa: F401  (module fixture)
    assert_pair_equal,
    bridged_engines,
    run_pair,
)

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=2e-5, rtol=2e-5)
#: the configs this slice brings: arch id -> module (the reference's)
NEW_ARCHS = {
    "llama2-7b": "llama2_7b_paper",
    "llama3.2-3b": "llama3_2_3b",
    "starcoder2-7b": "starcoder2_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "dbrx-132b": "dbrx_132b",
}
#: the configs of the last families' slice
FAMILY_ARCHS = {
    "whisper-tiny": "whisper_tiny",
    "llava-next-34b": "llava_next_34b",
    "zamba2-2.7b": "zamba2_2_7b",
}
#: reduced dense archs with their real q-per-kv ratio (``reduced()`` alone
#: gives 4/2 heads, qpk 2, at every arch)
DENSE_ZOO = {
    "llama2-7b": dict(n_heads=4, n_kv_heads=4),        # MHA, qpk 1
    "llama3.2-3b": dict(n_heads=6, n_kv_heads=2),      # qpk 3
    "starcoder2-7b": dict(n_heads=9, n_kv_heads=1),    # qpk 9
    "h2o-danube-1.8b": dict(n_heads=8, n_kv_heads=2),  # qpk 4, window 64
}


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", list(NEW_ARCHS) + list(FAMILY_ARCHS))
def test_config_equals_jax(arch):
    mod = {**NEW_ARCHS, **FAMILY_ARCHS}[arch]
    jax_mod = importlib.import_module(f"repro.configs.{mod}")
    port_mod = importlib.import_module(f"repro_torch.configs.{mod}")
    assert dataclasses.asdict(torch_get_config(arch)) == \
        dataclasses.asdict(get_config(arch))
    assert port_mod.LONG_CONTEXT_OVERRIDES == jax_mod.LONG_CONTEXT_OVERRIDES
    if jax_mod.LONG_CONTEXT_OVERRIDES is None:
        with pytest.raises(ValueError, match="skips long_500k"):
            torch_get_config(arch, shape="long_500k")
        return
    assert dataclasses.asdict(torch_get_config(arch, shape="long_500k")) == \
        dataclasses.asdict(get_config(arch, shape="long_500k"))


def test_registry_holds_the_reference_ids_in_its_order():
    assert ALL_ARCHS == JAX_ARCHS
    assert ASSIGNED_ARCHS == JAX_ASSIGNED


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_supports_shape_and_refusal_equal_jax(arch):
    for shape in JAX_SHAPES:
        assert supports_shape(arch, shape) == jax_supports_shape(arch, shape)
    if jax_supports_shape(arch, "long_500k"):
        return
    with pytest.raises(ValueError) as port_err:
        torch_get_config(arch, shape="long_500k")
    with pytest.raises(ValueError) as jax_err:
        get_config(arch, shape="long_500k")
    assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------------ model logits


@functools.lru_cache(maxsize=None)
def bridged_models(arch: str, **over):
    """The reduced JAX model (entry points jitted), its parameters, and the
    port's model on the CPU with the same parameters."""
    over = dict(vocab=VOCAB, **over)
    jm = JaxModel(get_config(arch).reduced(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(arch).reduced(**over), device="cpu",
               debug_checks=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jit = {"prefill": jax.jit(jm.prefill, static_argnames=("cache_len",)),
           "decode": jax.jit(jm.decode)}
    return jm, jp, tm, tp, jit


def compare_cache(cj, ct):
    kvp = np.asarray(cj["kv_pos"])
    np.testing.assert_array_equal(ct["kv_pos"].numpy(), kvp)
    valid = kvp >= 0
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy()[valid],
                                   np.asarray(cj[key])[valid], **CACHE_TOL)


def prefill_and_decode(models, toks, lens, cache_len: int, steps: int,
                       on_step=None):
    """One prefill of ``toks`` (B, S) with ``lens``, then ``steps`` greedy
    decode steps from JAX's argmax, on both sides; logits within 1e-5 and
    caches as ``compare_cache`` holds them after every call.  ``on_step``
    sees (step, the port's cache, positions just written).  Returns the
    port's cache."""
    _, jp, tm, tp, jit = models
    jl, jc = jit["prefill"](jp, {"tokens": jnp.asarray(toks),
                                 "lens": jnp.asarray(lens)},
                            cache_len=cache_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lens": torch.from_numpy(lens)},
                        cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    compare_cache(jc, tc)
    pos = lens.astype(np.int32)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for step in range(steps):
        jl, jc = jit["decode"](jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(nxt),
                           torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        compare_cache(jc, tc)
        if on_step is not None:
            on_step(step, tc, pos)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + 1
    return tc


@pytest.mark.parametrize("arch", list(DENSE_ZOO))
def test_prefill_and_decode_match_jax(arch):
    """A bucket-padded batch of three prompts (lens 64, 23, 50 in S 64),
    then 24 decode steps; at h2o-danube's window of 64 the 96-token cache
    is a ring, so decode runs past the window there."""
    models = bridged_models(arch, **DENSE_ZOO[arch])
    rng = np.random.default_rng(1)
    toks = rng.integers(0, VOCAB, (3, 64)).astype(np.int32)
    lens = np.array([64, 23, 50], np.int32)
    prefill_and_decode(models, toks, lens, cache_len=96, steps=24)


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("sched,pool", [("justitia", 4096), ("vtc", 256)])
@pytest.mark.parametrize("arch", list(DENSE_ZOO))
def test_engine_matches_jax(arch, sched, pool):
    """Seeded agents (prompts of 8-39 tokens, 16-47 new tokens) at
    ``cache_len`` 96; pool 256 forces swaps."""
    engines = _engines(arch)
    jax_run, torch_run = run_pair(
        engines, sched, make_agents=lambda c: synth_agents(c[0], 7, 6),
        pool_tokens=pool)
    assert_pair_equal(jax_run, torch_run)
    if pool == 256:
        assert torch_run[0]["metrics"]["swaps"] > 0


@functools.lru_cache(maxsize=None)
def _engines(arch):
    return bridged_engines(arch, vocab=VOCAB, **DENSE_ZOO[arch])


# ------------------------------------------------------------- the record


@pytest.mark.parametrize("run", list(smoke.ZOO_API_RUNS))
@pytest.mark.parametrize("arch", ["llama2-7b", "mixtral-8x7b"])
def test_zoo_runs_hold_the_record(arch, run):
    """The runs that ``chip_smoke.py`` phase 8 serves at llama2-7b and
    mixtral-8x7b: the port's own weights at reduced width, with the arch's
    full vocabulary and full-width window, give the JAX record made on
    granite-3-2b (no run's record depends on the arch)."""
    full = torch_get_config(arch)
    model = Model(full.reduced(vocab=full.vocab,
                               sliding_window=full.sliding_window),
                  device="cpu")
    got, _ = smoke.serve_api(api, model, model.init(seed=0),
                             smoke.API_RUNS[run])
    assert smoke.record_diff(got, RECORD["runs"][run]) == ""


@pytest.mark.parametrize("arch", list(NEW_ARCHS) + ["llava-next-34b"])
def test_service_for_backend_serves_the_arch(arch):
    """``service_for_backend("engine", arch=...)`` builds each new arch
    (reduced, as the launcher does: mixtral's window of 64 makes its
    512-token cache a ring; llava's token prompts, as the dense path) and
    serves the launcher's open workload as the JAX record has it."""
    svc = api.service_for_backend("engine", "justitia", arch=arch,
                                  device="cpu")
    handles = svc.submit_many(smoke.api_specs(api, smoke.API_RUNS["open"]))
    res = svc.drain()
    want = RECORD["runs"]["open"]
    assert {str(a): t for a, t in sorted(res.finish.items())} == \
        want["finish"]
    assert len(handles) == len(want["finish"])
