"""The port's sliding-window ring caches against the JAX package's (CPU,
float32, reduced h2o-danube-1.8b: window 64, 8/2 heads).

A cache is a ring where the window is smaller than the cache length: it
holds ``T = window`` rows and decode writes position p at row ``p mod T``.

* ``ring_update_cache``/``ring_update_pos`` against JAX's, past the wrap.
* ``_fill_kv`` on prompts longer than the window in a mixed-length batch:
  ``kv_pos`` equal to JAX's and the valid rows within 2e-5, and the
  reference's behaviour pinned (the port copies it on purpose): the
  prompt's last T tokens sit at rows 0..T-1, so an 80-token prompt puts
  position 16 at row 0 and 32 at row 16, and a shorter row of the same
  batch keeps only its positions at or past S - T.
* More decode steps than the ring has rows, logits within 1e-5 of JAX's
  at every step; decode position 80 overwrites row 16 (position 32, still
  inside the window) while row 0 keeps position 16, which the window
  masks.
* The engine at ``cache_len`` 160 > window on prompts of 70-120 tokens
  (bucket-padded to 128), exact against the JAX engine: completions,
  clock, every counter, every event and every sampled token.
* Fused prefill refuses a ring with the JAX engine's ``ValueError``.
* ``chip_smoke.RING_RUN`` at reduced width gives the JAX record that
  phase 8 holds the full-width model to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import make_scheduler
from repro.engine import ServeEngine as JaxEngine
from repro.models import Model as JaxModel
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core import InferenceSpec as TorchSpec
from repro_torch.core import agent_cost as torch_agent_cost
from repro_torch.core import make_scheduler as torch_make_scheduler
from repro_torch.engine import EngineAgent, ServeEngine
from repro_torch.models import Model
from repro_torch.models import transformer
from test_torch_api import RECORD, smoke
from test_torch_configs import DENSE_ZOO, bridged_models, prefill_and_decode
from test_torch_prefix import (
    VOCAB,
    _one_torch_thread,  # noqa: F401  (module fixture)
    assert_pair_equal,
    bridged_engines,
    run_pair,
)

ARCH = "h2o-danube-1.8b"
WINDOW = 64


def test_ring_updates_match_jax():
    rng = np.random.default_rng(0)
    b, t = 4, 8
    cache = rng.standard_normal((b, t, 2, 4)).astype(np.float32)
    kv_pos = rng.integers(-1, 20, (b, t)).astype(np.int32)
    for pos in ([0, 7, 8, 21], [3, 16, 9, 30]):   # on and past the wrap
        pos = np.array(pos, np.int32)
        new = rng.standard_normal((b, 1, 2, 4)).astype(np.float32)
        want = jax_transformer.ring_update_cache(
            jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
        want_pos = jax_transformer.ring_update_pos(jnp.asarray(kv_pos),
                                                   jnp.asarray(pos))
        got = transformer.ring_update_cache(
            torch.from_numpy(cache.copy()), torch.from_numpy(new),
            torch.from_numpy(pos))
        got_pos = transformer.ring_update_pos(torch.from_numpy(kv_pos.copy()),
                                              torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
        cache, kv_pos = got.numpy(), got_pos.numpy()


def _models():
    models = bridged_models(ARCH, **DENSE_ZOO[ARCH])
    assert models[2].cfg.sliding_window == WINDOW
    return models


def test_fill_kv_keeps_the_last_window_of_a_long_prompt():
    """S 80 in a 100-token cache (T 64 rows), lens 80, 30 and 70."""
    toks = np.random.default_rng(4).integers(0, VOCAB, (3, 80)).astype(
        np.int32)
    lens = np.array([80, 30, 70], np.int32)
    cache = prefill_and_decode(_models(), toks, lens, cache_len=100,
                               steps=0)
    kvp = cache["kv_pos"][0].numpy()          # layer 0, (B, T)
    assert kvp.shape == (3, WINDOW)
    np.testing.assert_array_equal(kvp[0], np.arange(16, 80))
    assert kvp[0, 0] == 16 and kvp[0, 16] == 32
    # the 30-token row keeps positions 16..29 only: its head rows are lost
    # although its own prompt fits in the window
    np.testing.assert_array_equal(kvp[1, :14], np.arange(16, 30))
    assert (kvp[1, 14:] == -1).all()
    np.testing.assert_array_equal(kvp[2, :54], np.arange(16, 70))
    assert (kvp[2, 54:] == -1).all()


def test_decode_past_the_wrap_matches_jax():
    """100 decode steps (more than the ring's 64 rows) after the 80-token
    prefill: logits and caches as JAX's at every step."""
    toks = np.random.default_rng(4).integers(0, VOCAB, (3, 80)).astype(
        np.int32)
    lens = np.array([80, 30, 70], np.int32)
    seen = {}

    def note(step, cache, pos):
        if step == 0:   # position 80 of row 0 written at ring row 16
            seen["after_80"] = cache["kv_pos"][0, 0].clone()

    prefill_and_decode(_models(), toks, lens, cache_len=100, steps=100,
                       on_step=note)
    row = seen["after_80"].numpy()
    assert row[16] == 80 and row[0] == 16
    # position 32 was overwritten while still inside the window of 80
    assert 32 not in row and 80 - 32 < WINDOW


def ring_agents(classes, seed=6, n=6):
    """Prompts of 70-120 tokens (longer than the window, bucket-padded to
    128), 16-39 new tokens: prompt and budget fit the 160-token cache."""
    agents, _ = smoke.seeded_agents(*classes, seed, n, (70, 121), (16, 40),
                                    VOCAB)
    return agents


@pytest.mark.parametrize("sched,pool", [("justitia", 4096), ("vtc", 512)])
def test_ring_engine_matches_jax(sched, pool):
    engines = bridged_engines(ARCH, vocab=VOCAB, **DENSE_ZOO[ARCH])
    jax_run, torch_run = run_pair(engines, sched, make_agents=ring_agents,
                                  cache_len=160, pool_tokens=pool)
    assert_pair_equal(jax_run, torch_run)
    eng = torch_run[2]
    assert eng.cache["k"].shape[2] == WINDOW
    if pool == 512:
        assert torch_run[0]["metrics"]["swaps"] > 0


def test_fused_gate_refuses_a_ring_as_jax_does():
    """The case of ``tests/test_fused_prefill.py::
    test_fused_rejects_ring_cache``, on both engines: the same
    ``ValueError``."""
    over = dict(vocab=VOCAB, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128)
    cfgs = (get_config(ARCH).reduced(**over),
            torch_get_config(ARCH).reduced(**over))
    assert cfgs[0].sliding_window and cfgs[0].sliding_window < 256
    errors = []
    for eng_cls, model, mk, extra in (
            (JaxEngine, JaxModel(cfgs[0]), make_scheduler, {}),
            (ServeEngine, Model(cfgs[1], device="cpu"), torch_make_scheduler,
             {"device": "cpu"})):
        with pytest.raises(ValueError, match="fused_prefill") as err:
            eng_cls(model, None, mk("justitia", 256.0), pool_tokens=256,
                    max_batch=2, cache_len=256, fused_prefill=True, **extra)
        errors.append(str(err.value))
    assert errors[1] == errors[0]


def test_ring_run_holds_the_record():
    """``chip_smoke.RING_RUN`` (h2o-danube-1.8b at its window of 4096 in a
    6144-token cache, prompts of 4,200-5,600 tokens) served by the port on
    the CPU at reduced width (one layer, one head, its own weights) gives
    the JAX engine's record exactly: the record phase 8 holds the
    full-width model to."""
    full = torch_get_config(ARCH)
    cfg = full.reduced(vocab=512, n_layers=1, n_heads=1, n_kv_heads=1,
                       sliding_window=full.sliding_window)
    model = Model(cfg, device="cpu")
    pkg = dict(InferenceSpec=TorchSpec, agent_cost=torch_agent_cost,
               make_scheduler=torch_make_scheduler, EngineAgent=EngineAgent,
               ServeEngine=ServeEngine)
    got, eng, _, _ = smoke.serve_ring(pkg, model, model.init(seed=0),
                                      device="cpu")
    assert eng.cache["k"].shape[2] == full.sliding_window
    assert got == RECORD["ring"]
