"""The port's ``Model.prefill_slice`` against the JAX ``Model.prefill_slice``
(reduced granite-3-2b, float32, bridged parameters, CPU).

One slice of one slot runs against a live cache of three slots whose rows
hold seeded K/V and contiguous ``kv_pos`` prefixes.  Compared: the logits
and the slot's valid K/V rows within 1e-5, ``kv_pos`` exactly, and every
other slot's rows (and the slot's rows outside the slice) bit-identical to
the cache they started from.  The cases: an emptied slot at start 0, a
slice after a prefix head, a slice that ends before the prompt does, a
zero-padded final slice, and slices whose tail runs past the cache end
(cache lengths 96 and 100, chunks 16 and 64), where JAX's scatter drops
the rows past the end and a clamped write would shift the slice down over
valid rows.
"""

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

VOCAB = 256
N_SLOTS = 3
TOL = dict(atol=1e-5, rtol=1e-5)


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


@functools.lru_cache(maxsize=None)
def _jitted(jm):
    return jax.jit(jm.prefill_slice)


def live_cache(cfg, t: int, slot: int, head: int, seed: int) -> dict:
    """A (L, N_SLOTS, T) cache with seeded K/V everywhere: every other slot
    valid on a contiguous prefix of seeded length, ``slot`` valid on its
    first ``head`` rows (0: emptied, its stale K/V kept)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, N_SLOTS, t, cfg.n_kv_heads, cfg.head_dim)
    kv_pos = np.full(shape[:3], -1, np.int32)
    for b in range(N_SLOTS):
        n = head if b == slot else int(rng.integers(1, t))
        kv_pos[:, b, :n] = np.arange(n, dtype=np.int32)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32),
            "kv_pos": kv_pos}


CASES = {   # cache length, chunk, start, total
    "empty_slot_start_0": (96, 16, 0, 40),
    "after_prefix_head": (96, 16, 32, 45),
    "ends_before_total": (96, 16, 16, 70),
    "padded_final_slice": (96, 16, 0, 10),
    "past_end_96_chunk_16": (96, 16, 88, 94),
    "past_end_96_chunk_64": (96, 64, 48, 90),
    "past_end_100_chunk_16": (100, 16, 96, 98),
    "past_end_100_chunk_64": (100, 64, 48, 98),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_slice_matches_jax(models, case):
    jm, jp, tm, tp = models
    t, chunk, start, total = CASES[case]
    slot = 1
    cache = live_cache(tm.cfg, t, slot, start, seed=len(case))
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, VOCAB, size=total).astype(np.int32)
    toks = np.zeros(chunk, np.int32)
    seg = prompt[start:start + chunk]
    toks[:len(seg)] = seg

    lj, cj = _jitted(jm)(jp, {k: jnp.asarray(v) for k, v in cache.items()},
                         jnp.asarray(toks), slot, start, total)
    ct = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    lt, out = tm.prefill_slice(tp, ct, torch.from_numpy(toks), slot, start,
                               total)
    assert out is ct
    assert lt.shape == (VOCAB,)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)

    kvp = np.asarray(cj["kv_pos"])
    np.testing.assert_array_equal(ct["kv_pos"].numpy(), kvp)
    # the slice's rows below the cache end, and nothing else, changed
    n = max(0, min(chunk, t - start))
    want_kvp = cache["kv_pos"].copy()
    idx = np.arange(start, start + n)
    want_kvp[:, slot, idx] = np.where(idx < total, idx, -1)
    np.testing.assert_array_equal(kvp, want_kvp)
    written = np.zeros((N_SLOTS, t), bool)
    written[slot, start:start + n] = True
    for key in ("k", "v"):
        got = ct[key].numpy()
        np.testing.assert_array_equal(got[:, ~written],
                                      cache[key][:, ~written])
        valid = written[None] & (kvp >= 0)
        np.testing.assert_allclose(got[valid], np.asarray(cj[key])[valid],
                                   **TOL)


def test_prefill_slice_rejects_ssm_as_jax_does():
    over = dict(vocab=VOCAB, n_layers=2)
    jm = JaxModel(get_config("xlstm-350m").reduced(**over))
    tm = Model(torch_get_config("xlstm-350m").reduced(**over), device="cpu")
    toks = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="unsupported model kind") as want:
        jm.prefill_slice({}, {}, jnp.asarray(toks), 0, 0, 8)
    with pytest.raises(ValueError, match="unsupported model kind") as got:
        tm.prefill_slice({}, {}, torch.from_numpy(toks), 0, 0, 8)
    assert str(got.value) == str(want.value)
