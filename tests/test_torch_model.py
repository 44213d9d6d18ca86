"""Parity of the port's ``Model`` with the JAX ``Model`` with bridged
parameters: reduced granite-3-2b (one-shot prefill, chunked prefill with
chunk < S, decode steps) and reduced xlstm-350m (prefill, decode steps),
compared on the logits and the caches.

Tolerance: 1e-5 absolute and relative at float32 on the logits; the cache
K/V rows that ``kv_pos`` marks valid agree to 2e-5 (they are one projection
deeper than the embeddings, summed in another order), and so do the xLSTM
state leaves.  Cache rows marked invalid are never read and are not
compared: padded prompt rows differ by design (see
``repro_torch.models.transformer``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import check_slot_contiguous

VOCAB = 256
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
CACHE_TOL = dict(atol=2e-5, rtol=2e-5)
CACHE_LEN = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster and
    keeps the workers from oversubscribing the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(get_config("granite-3-2b").reduced(vocab=VOCAB))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config("granite-3-2b").reduced(vocab=VOCAB),
               device="cpu", debug_checks=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _prompt(seed, b=3, s=40):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    lens = np.array([s, 17, 33][:b], np.int32)
    return toks, lens


def _compare_cache(cj, ct):
    kvp = np.asarray(cj["kv_pos"])
    np.testing.assert_array_equal(kvp, ct["kv_pos"].numpy())
    valid = kvp >= 0
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy()[valid],
                                   np.asarray(cj[key])[valid], **CACHE_TOL)


@functools.lru_cache(maxsize=None)
def _jitted(jm, name):
    """The JAX entry points compiled once (eager dispatch would compile
    every op separately)."""
    static = {"prefill": ("cache_len",),
              "prefill_chunked": ("cache_len", "chunk")}.get(name, ())
    return jax.jit(getattr(jm, name), static_argnames=static)


def _run_prefill(models, chunk, cache_len=CACHE_LEN):
    jm, jp, tm, tp = models
    toks, lens = _prompt(0)
    if chunk is None:
        lj, cj = _jitted(jm, "prefill")(
            jp, {"tokens": jnp.asarray(toks), "lens": jnp.asarray(lens)},
            cache_len=cache_len)
        lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "lens": torch.from_numpy(lens)}, cache_len)
    else:
        lj, cj = _jitted(jm, "prefill_chunked")(
            jp, {"tokens": jnp.asarray(toks), "lens": jnp.asarray(lens)},
            cache_len=cache_len, chunk=chunk,
        )
        lt, ct = tm.prefill_chunked(
            tp, {"tokens": torch.from_numpy(toks),
                 "lens": torch.from_numpy(lens)}, cache_len, chunk,
        )
    return lj, cj, lt, ct, lens


@pytest.mark.parametrize("chunk", [None, 16, 64], ids=["one_shot",
                                                        "chunked",
                                                        "chunk_fallback"])
def test_prefill_matches_jax(models, chunk):
    lj, cj, lt, ct, _ = _run_prefill(models, chunk)
    assert lt.shape == (3, 1, VOCAB)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    _compare_cache(cj, ct)


@pytest.mark.parametrize("chunk", [None, 16], ids=["one_shot", "chunked"])
def test_decode_steps_match_jax(models, chunk):
    """Eight greedy decode steps from each prefill: logits and caches agree
    with JAX at every step, and the slot-contiguity precondition of paged
    decode holds after every step."""
    _decode_steps(models, chunk, CACHE_LEN, 8)


@pytest.mark.parametrize("cache_len", [100, 97])
def test_decode_at_any_cache_len_matches_jax(models, cache_len):
    """A cache length that the 16-token decode page does not divide (pages
    of 10 tokens at 100, of 1 at the prime 97), served as JAX serves it:
    prefill, then decode steps up to the cache's last row."""
    _decode_steps(models, None, cache_len)


def _decode_steps(models, chunk, cache_len, n_steps=None):
    """``n_steps`` greedy decode steps after a prefill (None: until the
    longest row has filled the cache), compared with JAX at every step."""
    jm, jp, tm, tp = models
    lj, cj, lt, ct, lens = _run_prefill(models, chunk, cache_len)
    if n_steps is None:
        n_steps = cache_len - int(lens.max())
    pos = lens.copy()
    tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)[:, None]
    for _ in range(n_steps):
        lj, cj = _jitted(jm, "decode")(jp, cj, jnp.asarray(tok),
                                       jnp.asarray(pos))
        lt, ct = tm.decode(tp, ct, torch.from_numpy(tok),
                           torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        _compare_cache(cj, ct)
        check_slot_contiguous(ct["kv_pos"], torch.from_numpy(pos))
        tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)[:, None]
        pos = pos + 1


def test_init_layout_matches_jax_tree(models):
    """``Model.init`` builds the JAX parameter tree's keys and stacked
    shapes, so the bridge is a key-for-key copy."""
    jm, jp, tm, _ = models
    mine = tm.init(seed=3)
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    got = jax.tree.map(lambda t: tuple(t.shape), mine)
    assert got == want
    assert mine["final_norm"].dtype == torch.float32


def test_debug_check_catches_non_contiguous_cache(models):
    _, _, tm, tp = models
    cache = tm.init_cache(tp, 2, 32)
    # a row past slot 1's position that the masked dense attention would
    # read but a length-(pos+1) page walk would not
    cache["kv_pos"][:, 1, 3] = 0
    with pytest.raises(RuntimeError, match=r"slots \[1\]"):
        tm.decode(tp, cache, torch.zeros((2, 1), dtype=torch.int32),
                  torch.zeros((2,), dtype=torch.int32))


@pytest.mark.parametrize("kind,over", [
    ("moe", dict(n_experts=4, top_k=2)),
    ("vlm", dict(n_image_tokens=8)),
    ("hybrid", dict(ssm_state=16, attn_every=2)),
    ("dense", dict(sliding_window=16)),
    ("encdec", dict(n_enc_layers=2)),
])
def test_later_slices_raise(models, kind, over):
    """Families and layouts of later slices refuse with NotImplementedError
    naming their slice (ring: a sliding window smaller than the cache)."""
    _, _, tm, tp = models
    cfg = dataclasses.replace(tm.cfg, kind=kind, **over)
    m = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        if kind == "dense":
            cache = m.init_cache(tp, 1, 64)
            m.decode(tp, cache, torch.zeros((1, 1), dtype=torch.int32),
                     torch.zeros((1,), dtype=torch.int32))
        else:
            m.init_cache(tp, 1, 64)



def test_bridge_casts_weights_and_keeps_norms_f32(models):
    """``params_from_jax(..., dtype)`` casts the weights to the compute
    dtype and keeps the norm scales in float32, as ``Model.init`` does."""
    jm, jp, _, tp = models
    bf = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert bf["blocks"]["ln1"].dtype == torch.float32
    assert bf["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        bf["blocks"]["mlp"]["w1"].float().numpy(),
        tp["blocks"]["mlp"]["w1"].to(torch.bfloat16).float().numpy(),
    )


# ------------------------------------------------------------------- xLSTM

#: 2 mLSTM/sLSTM pairs, d_model 128, 4 heads of 32
XLSTM_LAYERS = 4
SSM_KEYS = ("mlstm_c", "mlstm_n", "mlstm_m", "slstm_c", "slstm_n",
            "slstm_h", "slstm_m")


@pytest.fixture(scope="module")
def xlstm():
    over = dict(vocab=VOCAB, n_layers=XLSTM_LAYERS)
    jm = JaxModel(get_config("xlstm-350m").reduced(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(torch_get_config("xlstm-350m").reduced(**over), device="cpu",
               debug_checks=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _compare_states(cj, ct):
    assert set(ct) == set(SSM_KEYS) == set(cj)
    for key in SSM_KEYS:
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   **CACHE_TOL, err_msg=key)


@pytest.mark.parametrize("s", [29, 70])
def test_xlstm_prefill_and_decode_match_jax(xlstm, s):
    """Prefill (ragged in the port's 64-token chunks at S=70, one chunk in
    JAX's) then four greedy decode steps: logits and every state leaf."""
    jm, jp, tm, tp = xlstm
    toks = np.random.default_rng(s).integers(0, VOCAB, (2, s)).astype(
        np.int32)
    lj, cj = _jitted(jm, "prefill")(jp, {"tokens": jnp.asarray(toks)},
                                    cache_len=CACHE_LEN)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, CACHE_LEN)
    assert lt.shape == (2, 1, VOCAB)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    _compare_states(cj, ct)
    pos = np.full((2,), s, np.int32)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(lj[:, 0], -1)).astype(np.int32)[:, None]
        lj, cj = _jitted(jm, "decode")(jp, cj, jnp.asarray(tok),
                                       jnp.asarray(pos))
        lt, ct = tm.decode(tp, ct, torch.from_numpy(tok),
                           torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        _compare_states(cj, ct)
        pos = pos + 1


def test_xlstm_chunked_prefill_falls_back_to_one_shot(xlstm):
    """``prefill_chunked`` of the ssm family is the one-shot prefill, as in
    the JAX package."""
    _, _, tm, tp = xlstm
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, VOCAB, (1, 50)).astype(np.int32))
    la, ca = tm.prefill(tp, {"tokens": toks}, CACHE_LEN)
    lb, cb = tm.prefill_chunked(tp, {"tokens": toks}, CACHE_LEN, chunk=16)
    torch.testing.assert_close(lb, la, rtol=0, atol=0)
    for key in SSM_KEYS:
        torch.testing.assert_close(cb[key], ca[key], rtol=0, atol=0)


def test_xlstm_init_layout_matches_jax_tree(xlstm):
    jm, jp, tm, _ = xlstm
    mine = tm.init(seed=3)
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    got = jax.tree.map(lambda t: tuple(t.shape), mine)
    assert got == want
    cache = tm.init_cache(mine, 3, 64)
    jcache = jm.init_cache(jp, 3, 64)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    _compare_states(jcache, cache)


def test_bridge_keeps_xlstm_f32_leaves(xlstm):
    """A bf16-bridged xLSTM tree has, leaf for leaf, the dtypes of the
    port's own ``Model.init`` at the bf16 config: the gate projections and
    biases, head norms, sLSTM recurrent matrices and bias stay float32."""
    jm, jp, tm, _ = xlstm
    bf = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.bfloat16)
    own = Model(dataclasses.replace(tm.cfg, dtype="bfloat16"),
                device="cpu").init(seed=0)
    dtypes = functools.partial(jax.tree.map, lambda t: str(t.dtype))
    assert dtypes(bf) == dtypes(own)
    assert bf["xlstm_pairs"]["slstm"]["r"].dtype == torch.float32
    assert bf["xlstm_pairs"]["mlstm"]["wq"].dtype == torch.bfloat16
