"""The port's last three families against the JAX package's (CPU, float32):
vlm (llava-next-34b), hybrid (zamba2-2.7b) and encdec (whisper-tiny),
reduced, each at its arch's real ratio of q heads to kv heads.

Parameters come from the JAX ``Model.init`` through ``params_from_jax``;
token prompts, image embeddings and audio frames from a numpy seed.

* ``Model.init`` and ``Model.init_cache`` build JAX's keys, shapes and
  dtypes, at float32 and at bfloat16 weights; a bfloat16 bridge keeps
  every leaf that JAX keeps float32.
* Prefill logits within 1e-5 and every cache leaf (``kv_pos`` and
  ``enc_len`` equal, the valid K/V rows, the Mamba2 states and conv states
  and the cross-attention K/V within 2e-5; the tolerances of
  ``tests/test_torch_model.py``), then 4 greedy decode steps with logits
  within 1e-5 and the caches as after prefill: llava with image
  embeddings, with them and ragged lens, and without them (the dense
  path); zamba2 and whisper with ragged lens.  A ragged batch's padding
  rows run through zamba2's Mamba2 state in both packages.
* ``prefill_chunked`` follows JAX's rules: one-shot for image batches,
  the hybrid and the encoder-decoder, chunked for llava's token prompts.
* The reduced llava engine is exact against the JAX engine (completions,
  clock, every counter, every event and every sampled token), unfused and
  fused.  The port's engine, ``EngineBackend`` and ``service_for_backend``
  refuse zamba2 and whisper with ``NotImplementedError`` naming the
  reference's limit, and the JAX engine fails on the same configs.
* ``init_dense_blocks`` draws no float32 tensor of a whole layer stack.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import InferenceSpec, agent_cost, make_scheduler
from repro.engine import EngineAgent as JaxAgent
from repro.engine import ServeEngine as JaxEngine
from repro.models import Model as JaxModel
from repro_torch import api
from repro_torch.configs import get_config as torch_get_config
from repro_torch.engine import ServeEngine
from repro_torch.models import Model
from repro_torch.models import transformer
from repro_torch.models.params import params_from_jax
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
CACHE_LEN = 96
#: reduced archs with their real q-per-kv ratio (``reduced()`` alone gives
#: 4/2 heads); zamba2 with two super blocks of two Mamba2 layers
REDUCED = {
    "llava-next-34b": dict(n_heads=7, n_kv_heads=1),     # qpk 7
    "zamba2-2.7b": dict(n_heads=4, n_kv_heads=4, n_layers=4),   # MHA
    "whisper-tiny": dict(n_heads=4, n_kv_heads=4),       # MHA
}
#: case -> (arch, batch, text tokens, lens, image embeddings or frames)
CASES = {
    "llava_embeds": ("llava-next-34b", 2, 24, [24, 24], True),
    "llava_embeds_ragged": ("llava-next-34b", 2, 24, [24, 13], True),
    "llava_tokens": ("llava-next-34b", 3, 40, [40, 17, 33], False),
    "zamba2": ("zamba2-2.7b", 2, 40, [40, 23], False),
    "whisper": ("whisper-tiny", 2, 12, [12, 7], True),
}


# ----------------------------------------------------------------- models


@functools.lru_cache(maxsize=None)
def bridged(arch: str):
    """The reduced JAX model (entry points jitted), its parameters, and the
    port's model on the CPU with the same parameters."""
    over = dict(vocab=VOCAB, **REDUCED[arch])
    jm = JaxModel(get_config(arch).reduced(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config(arch).reduced(**over), device="cpu",
               debug_checks=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jit = {"prefill": jax.jit(jm.prefill, static_argnames=("cache_len",)),
           "prefill_chunked": jax.jit(jm.prefill_chunked,
                                      static_argnames=("cache_len", "chunk")),
           "decode": jax.jit(jm.decode)}
    return jm, jp, tm, tp, jit


def _batch(case: str, seed: int = 0):
    """The case's batch as numpy arrays: tokens, lens and, where the case
    has them, llava's image embeddings or whisper's frames."""
    arch, b, s, lens, embeds = CASES[case]
    cfg = torch_get_config(arch).reduced(vocab=VOCAB, **REDUCED[arch])
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, VOCAB, (b, s)).astype(np.int32),
             "lens": np.array(lens, np.int32)}
    if embeds:
        n = cfg.n_image_tokens if cfg.kind == "vlm" else cfg.n_audio_frames
        batch["embeds"] = rng.standard_normal((b, n, cfg.d_model)).astype(
            np.float32)
    return batch


def _compare_cache(cj, ct):
    """Every cache leaf: ``kv_pos`` and ``enc_len`` equal, the K/V rows that
    ``kv_pos`` marks valid and every other float leaf within 2e-5."""
    assert set(ct) == set(cj)
    kvp = np.asarray(cj["kv_pos"])
    np.testing.assert_array_equal(ct["kv_pos"].numpy(), kvp)
    valid = kvp >= 0
    for key, want in cj.items():
        got, want = ct[key].numpy(), np.asarray(want)
        assert got.shape == want.shape, key
        if key in ("k", "v"):
            got, want = got[valid], want[valid]
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, **CACHE_TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def _prefill(models, batch, entry="prefill", **kw):
    _, jp, tm, tp, jit = models
    lj, cj = jit[entry](jp, jax.tree.map(jnp.asarray, batch),
                        cache_len=CACHE_LEN, **kw)
    lt, ct = getattr(tm, entry)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        CACHE_LEN, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    _compare_cache(cj, ct)
    return lj, cj, lt, ct


@pytest.mark.parametrize("arch", list(REDUCED))
def test_init_layout_matches_jax(arch):
    """Keys, shapes and dtypes of ``Model.init`` and ``init_cache`` equal
    JAX's at float32 and at bfloat16 weights; a bfloat16 bridge of JAX's
    float32 tree has, leaf for leaf, the dtypes of the port's own bfloat16
    init (the norms, Mamba2's decay logs, step biases and skip scales
    float32)."""
    jm, jp, tm, _, _ = bridged(arch)
    layout = functools.partial(
        jax.tree.map, lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]))
    assert layout(tm.init(seed=3)) == layout(jp)
    assert layout(tm.init_cache(None, 3, 64)) == \
        layout(jm.init_cache(jp, 3, 64))
    bf_cfg = dataclasses.replace(tm.cfg, dtype="bfloat16")
    bf_jax = JaxModel(dataclasses.replace(jm.cfg, dtype="bfloat16"))
    own = Model(bf_cfg, device="cpu").init(seed=0)
    assert layout(own) == layout(bf_jax.init(jax.random.PRNGKey(0)))
    bridged_bf = params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                                 torch.bfloat16)
    assert layout(bridged_bf) == layout(own)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    models = bridged(CASES[case][0])
    _, jp, tm, tp, jit = models
    batch = _batch(case)
    lj, cj, _, ct = _prefill(models, batch)
    pos = batch["lens"].copy()
    if tm.cfg.kind == "vlm" and "embeds" in batch:
        pos += batch["embeds"].shape[1]
    for _ in range(4):
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)
        lj, cj = jit["decode"](jp, cj, jnp.asarray(nxt), jnp.asarray(pos))
        lt, ct = tm.decode(tp, ct, torch.from_numpy(nxt),
                           torch.from_numpy(pos))
        assert lt.shape == (len(pos), 1, VOCAB)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        _compare_cache(cj, ct)
        pos = pos + 1


def test_padding_rows_run_through_the_mamba_state():
    """Row 1 of the zamba2 case (23 tokens padded to 40) ends in another
    Mamba2 state than the same prompt prefilled alone at its length, in
    JAX and in the port alike: the padding rows run through the state."""
    models = bridged("zamba2-2.7b")
    batch = _batch("zamba2")
    _, cj, _, ct = _prefill(models, batch)
    alone = {"tokens": batch["tokens"][1:2, :23],
             "lens": batch["lens"][1:2]}
    _, cj1, _, ct1 = _prefill(models, alone)
    for key in ("mamba_h", "mamba_conv"):
        padded, own = ct[key][:, :, 1], ct1[key][:, :, 0]
        assert not torch.allclose(padded, own, atol=1e-3), key
        np.testing.assert_allclose(np.asarray(cj1[key])[:, :, 0],
                                   own.numpy(), **CACHE_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_chunked_follows_jax(case):
    """``prefill_chunked`` in 16-token chunks against JAX's: one-shot (equal
    to the port's own ``prefill``) for image batches, the hybrid and the
    encoder-decoder; chunked for llava's token prompts."""
    models = bridged(CASES[case][0])
    tm, tp = models[2], models[3]
    batch = _batch(case)
    _, _, lt, ct = _prefill(models, batch, "prefill_chunked", chunk=16)
    one_shot = tm.cfg.kind != "vlm" or "embeds" in batch
    if one_shot:
        lo, co = tm.prefill(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()},
            CACHE_LEN)
        torch.testing.assert_close(lt, lo, rtol=0, atol=0)
        for key in co:
            torch.testing.assert_close(ct[key], co[key], rtol=0, atol=0)


def test_embeds_change_the_vlm_prefill():
    """The image rows take part: llava's prefill with embeddings differs
    from the same tokens without them, and its cache holds image plus
    text positions."""
    models = bridged("llava-next-34b")
    batch = _batch("llava_embeds")
    _, _, with_img, ct = _prefill(models, batch)
    text = {k: v for k, v in batch.items() if k != "embeds"}
    _, _, without, _ = _prefill(models, text)
    assert not torch.allclose(with_img, without, atol=1e-3)
    n = batch["embeds"].shape[1] + batch["tokens"].shape[1]
    assert int(ct["kv_pos"].max()) == n - 1


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("sched,pool,fused", [
    ("justitia", 4096, False), ("vtc", 256, False), ("justitia", 4096, True),
], ids=["justitia", "vtc_swaps", "fused"])
def test_llava_engine_matches_jax(sched, pool, fused):
    """Seeded agents (prompts of 8-39 tokens, 16-47 new tokens) at
    ``cache_len`` 96 on reduced llava (token prompts: the engine passes no
    images, as the JAX engine); pool 256 forces swaps."""
    engines = _llava_engines()
    jax_run, torch_run = run_pair(
        engines, sched, make_agents=lambda c: synth_agents(c[0], 7, 6),
        pool_tokens=pool, fused_prefill=fused, prefill_chunk=16)
    assert_pair_equal(jax_run, torch_run)
    metrics = torch_run[0]["metrics"]
    if pool == 256:
        assert metrics["swaps"] > 0
    if fused:
        assert metrics["fused_slices"] > 0


@functools.lru_cache(maxsize=None)
def _llava_engines():
    return bridged_engines("llava-next-34b", vocab=VOCAB,
                           **REDUCED["llava-next-34b"])


#: the reference's limit each refusal names
LIMITS = {"zamba2-2.7b": "axis 1", "whisper-tiny": "embeds"}


@pytest.mark.parametrize("entry", ["ServeEngine", "EngineBackend",
                                   "service_for_backend"])
@pytest.mark.parametrize("arch", list(LIMITS))
def test_engine_refuses_what_the_jax_engine_cannot_serve(arch, entry):
    cfg = torch_get_config(arch).reduced(vocab=VOCAB)
    with pytest.raises(NotImplementedError, match=LIMITS[arch]):
        if entry == "service_for_backend":
            api.service_for_backend("engine", "justitia", arch=arch,
                                    device="cpu")
            return
        model = Model(cfg, device="cpu")
        params = model.init(seed=0)
        if entry == "ServeEngine":
            from repro_torch.core import make_scheduler as torch_sched
            ServeEngine(model, params, torch_sched("justitia", 4096.0),
                        device="cpu")
        else:
            api.EngineBackend(model, params, "justitia")


@pytest.mark.parametrize("arch,error,match", [
    ("zamba2-2.7b", ValueError, "Incompatible shapes for broadcasting"),
    ("whisper-tiny", KeyError, "embeds"),
])
def test_jax_engine_fails_on_the_same_configs(arch, error, match):
    """The reference's limit: the JAX engine fails at the first prefill,
    the hybrid in its slot scatter (batch on axis 1), the encoder-decoder
    for want of the audio frames."""
    model = JaxModel(get_config(arch).reduced(vocab=VOCAB))
    params = model.init(jax.random.PRNGKey(0))
    eng = JaxEngine(model, params, make_scheduler("justitia", 4096.0),
                    max_batch=4, cache_len=128)
    spec = [(np.arange(12, dtype=np.int32) % VOCAB, 4)]
    eng.submit_agent(JaxAgent(0, 0, [spec],
                              agent_cost([InferenceSpec(12, 4)])))
    with pytest.raises(error, match=match):
        eng.run_until_idle()


# ------------------------------------------------------------------- init


def test_dense_init_draws_one_layer_at_a_time(monkeypatch):
    """No float32 draw of a whole ``(L, ...)`` stack: every ``torch.randn``
    that ``init_dense_blocks`` makes is one layer's leaf, and the stack it
    fills is in the compute dtype."""
    cfg = torch_get_config("llava-next-34b").reduced(
        vocab=VOCAB, dtype="bfloat16", n_layers=6)
    draws = []
    randn = torch.randn

    def spy(*args, **kw):
        out = randn(*args, **kw)
        draws.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "randn", spy)
    blocks = transformer.init_dense_blocks(torch.Generator(), cfg,
                                           torch.bfloat16, "cpu")
    layer = max(cfg.d_model * cfg.d_ff,
                cfg.d_model * cfg.n_heads * cfg.head_dim)
    assert draws and max(int(np.prod(s)) for s in draws) == layer
    assert all(s[0] != cfg.n_layers for s in draws)
    assert blocks["mlp"]["w1"].shape == (6, cfg.d_model, cfg.d_ff)
    assert blocks["mlp"]["w1"].dtype == torch.bfloat16
    assert blocks["attn"]["wq"].dtype == torch.bfloat16
