"""The port's MoE family against the JAX package's (CPU, float32).

* ``layers.moe_mlp`` against ``repro.models.layers.moe_mlp`` on the same
  seeded inputs and bridged weights, output and aux loss within 1e-5: one
  token (the decode step, an expert buffer of 1), a bucket-padded prompt,
  several groups (small ``group_size``, a snapped group size), capacity
  overflow (small ``capacity_factor``) and built ties (router columns in
  groups of three equal ones give exactly equal gate probabilities, and
  the top-k chooses among them: the lower expert first, as
  ``jax.lax.top_k`` does), at mixtral's 8 experts top-2 and dbrx's 16
  top-4.
* ``init_moe``: the tree, shapes and dtypes of ``Model.init`` equal
  JAX's, the router float32 at bfloat16 weights, and a bfloat16 bridge
  keeps every router leaf float32.
* Reduced mixtral-8x7b and dbrx-132b: prefill and decode logits within
  1e-5; the engine, unfused and fused, exact against the JAX engine
  (completions, clock, every counter, every event and sampled token).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.models.params import params_from_jax
from test_torch_configs import bridged_models, prefill_and_decode
from test_torch_engine import synth_agents
from test_torch_prefix import (
    VOCAB,
    _one_torch_thread,  # noqa: F401  (module fixture)
    assert_pair_equal,
    bridged_engines,
    run_pair,
)

TOL = dict(atol=1e-5, rtol=1e-5)
D_MODEL, D_FF = 64, 96
#: case -> (experts, top_k, B, S, capacity_factor, group_size, ties)
MOE_CASES = {
    "decode_s1": (8, 2, 4, 1, 1.25, 1024, False),
    "decode_s1_dbrx": (16, 4, 4, 1, 1.25, 1024, False),
    "bucket_padded": (8, 2, 2, 128, 1.25, 1024, False),
    "groups": (8, 2, 2, 96, 1.25, 32, False),
    "snapped_group": (16, 4, 1, 100, 1.25, 30, False),
    "overflow": (8, 2, 2, 64, 0.25, 1024, False),
    "ties": (8, 2, 2, 64, 0.5, 1024, True),
    "ties_dbrx": (16, 4, 1, 48, 0.5, 16, True),
}


def moe_inputs(e, b, s, ties, seed=0):
    """JAX ``init_moe`` weights and a seeded (B, S, D) input; with ``ties``
    the router's columns come in groups of three equal ones, so that the
    top-k must choose among equal gates (at top-2 within the best group,
    at top-4 within the second)."""
    p = jax_layers.init_moe(jax.random.PRNGKey(seed), D_MODEL, D_FF, e,
                            jnp.float32)
    p = jax.tree.map(np.asarray, p)
    if ties:
        router = p["router"].copy()
        for j in range(e):
            router[:, j] = router[:, j - j % 3]
        p["router"] = router
    x = np.random.default_rng(seed).standard_normal(
        (b, s, D_MODEL)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_matches_jax(case):
    e, k, b, s, cf, group, ties = MOE_CASES[case]
    p, x = moe_inputs(e, b, s, ties)
    want, want_aux = jax.jit(
        jax_layers.moe_mlp,
        static_argnames=("top_k", "capacity_factor", "group_size"),
    )(jax.tree.map(jnp.asarray, p), jnp.asarray(x), top_k=k,
      capacity_factor=cf, group_size=group)
    got, aux = layers.moe_mlp(params_from_jax(p, "cpu"), torch.from_numpy(x),
                              top_k=k, capacity_factor=cf, group_size=group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    if case == "overflow":   # some tokens fell through the residual
        assert (np.abs(np.asarray(want)).sum(-1) == 0).any()


def test_top_k_takes_the_lower_index_first():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, (64, 16)).astype(np.float32)   # many ties
    for k in (1, 2, 4):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = layers.top_k_lower_index_first(torch.from_numpy(x),
                                                      k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _tree_spec(tree):
    if isinstance(tree, dict):
        return {k: _tree_spec(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_init_moe_tree_and_bf16_bridge(arch):
    """The port's bfloat16 ``Model.init`` has JAX's tree, shapes and
    dtypes (stacked ``(L, E, ...)`` experts, float32 router), and a
    bfloat16 bridge of JAX's parameters keeps the router float32."""
    cfg = get_config(arch).reduced(vocab=VOCAB, dtype="bfloat16")
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tp = Model(torch_get_config(arch).reduced(vocab=VOCAB, dtype="bfloat16"),
               device="cpu").init(seed=0)
    assert _tree_spec(tp) == _tree_spec(jax.tree.map(np.asarray, jp))
    moe = tp["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w1"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                               cfg.d_ff)
    f32 = JaxModel(get_config(arch).reduced(vocab=VOCAB)).init(
        jax.random.PRNGKey(0))
    bridged = params_from_jax(jax.tree.map(np.asarray, f32), "cpu",
                              torch.bfloat16)
    assert bridged["blocks"]["moe"]["router"].dtype == torch.float32
    assert bridged["blocks"]["moe"]["w1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bridged["blocks"]["moe"]["router"].numpy(),
                                  np.asarray(f32["blocks"]["moe"]["router"]))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_prefill_and_decode_match_jax(arch):
    """A bucket-padded batch (lens 64, 23, 50 in S 64) and 24 decode steps
    at ``cache_len`` 96 (mixtral's window of 64 makes that a ring)."""
    models = bridged_models(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, VOCAB, (3, 64)).astype(np.int32)
    lens = np.array([64, 23, 50], np.int32)
    prefill_and_decode(models, toks, lens, cache_len=96, steps=24)


#: engine cases: arch, config overrides, fused prefill.  Mixtral's window
#: of 64 makes ``cache_len`` 96 a ring (fused prefill refuses it), so its
#: fused case widens the window to the cache length: the engine then calls
#: the cache no ring while ``Model.decode`` decodes it as one, as in JAX
ENGINE_CASES = {
    "mixtral_ring": ("mixtral-8x7b", {}, False),
    "mixtral_fused_window_eq_cache": ("mixtral-8x7b",
                                      dict(sliding_window=96), True),
    "dbrx": ("dbrx-132b", {}, False),
    "dbrx_fused": ("dbrx-132b", {}, True),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_moe_engine_matches_jax(case):
    arch, over, fused = ENGINE_CASES[case]
    engines = bridged_engines(arch, vocab=VOCAB, **over)
    jax_run, torch_run = run_pair(
        engines, "justitia", make_agents=lambda c: synth_agents(c[0], 7, 6),
        pool_tokens=256, fused_prefill=fused, prefill_chunk=16)
    assert_pair_equal(jax_run, torch_run)
    metrics = torch_run[0]["metrics"]
    assert (metrics["fused_slices"] > 0) == fused
    if not fused:
        assert metrics["swaps"] > 0
