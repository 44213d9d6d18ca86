"""The port's attention kernels on the CPU: their plain versions against the
JAX package's Pallas kernels run in interpret mode (as ``test_kernels.py``
runs them), the wrappers' CPU dispatch and launch counters, the argument
checks of the CUDA launchers, and the decode-through-pages wiring.

Tolerance: 2e-5 absolute and relative at float32, the tolerance of
``tests/test_kernels.py``.  The CUDA kernels themselves need the card:
``chip_smoke.py`` holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.layers import gqa_attention
from repro_torch.models.transformer import (
    DECODE_PAGE,
    _decode_attention,
    check_slot_contiguous,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _np32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize(
    "b,nh,nkv,hd,bs,pages,max_pages",
    [
        (3, 8, 2, 64, 16, 32, 6),      # GQA 4:1
        (2, 8, 1, 32, 16, 16, 8),      # MQA
    ],
)
def test_paged_decode_plain_matches_pallas(b, nh, nkv, hd, bs, pages,
                                           max_pages):
    rng = np.random.default_rng(0)
    q = _np32(rng, b, nh, hd)
    kp = _np32(rng, pages, bs, nkv, hd)
    vp = _np32(rng, pages, bs, nkv, hd)
    tables = rng.integers(0, pages, (b, max_pages)).astype(np.int32)
    lengths = np.linspace(1, max_pages * bs, b).astype(np.int32)
    want = jops.paged_gqa_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
        block_size=bs, interpret=True,
    )
    got = ops.paged_gqa_decode(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)),
        block_size=bs,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.paged_gqa_decode.launches == 0


def test_paged_decode_length_edges():
    b, nh, nkv, hd, bs, pages, mp = 4, 4, 2, 64, 16, 8, 4
    rng = np.random.default_rng(1)
    q = _np32(rng, b, nh, hd)
    kp = _np32(rng, pages, bs, nkv, hd)
    vp = _np32(rng, pages, bs, nkv, hd)
    tables = rng.integers(0, pages, (b, mp)).astype(np.int32)
    lengths = np.array([1, bs, bs + 1, mp * bs], np.int32)
    want = jops.paged_gqa_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
        block_size=bs, interpret=True,
    )
    got = ops.paged_gqa_decode(
        *(torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)),
        block_size=bs,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "b,s,nh,nkv,hd,blk,window",
    [
        (2, 128, 4, 2, 64, 64, 0),     # GQA
        (1, 128, 4, 1, 32, 64, 0),     # MQA
        (2, 128, 4, 2, 32, 32, 48),    # SWA
    ],
)
def test_flash_prefill_plain_matches_pallas(b, s, nh, nkv, hd, blk, window):
    rng = np.random.default_rng(2)
    q = _np32(rng, b, s, nh, hd)
    k = _np32(rng, b, s, nkv, hd)
    v = _np32(rng, b, s, nkv, hd)
    want = jops.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=blk, block_k=blk, interpret=True,
    )
    got = ops.flash_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window, block_q=blk, block_k=blk,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.flash_prefill.launches == 0


def test_flash_prefill_rejects_misaligned_seq():
    q = torch.zeros((1, 100, 2, 64))
    with pytest.raises(ValueError):
        ops.flash_prefill(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError):
        jops.flash_prefill(jnp.zeros((1, 100, 2, 64)), jnp.zeros((1, 100, 2, 64)),
                           jnp.zeros((1, 100, 2, 64)), block_q=64,
                           block_k=64, interpret=True)


@pytest.mark.parametrize("launcher", ["paged", "flash"])
def test_cuda_launchers_refuse_cpu_tensors(launcher):
    """The CUDA path never quietly runs on CPU tensors: the launchers check
    the device before touching the C entry point (which is never called
    here)."""
    def no_call(*_):
        raise AssertionError("the kernel entry point must not be reached")

    q = torch.zeros((1, 2, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        if launcher == "paged":
            pages = torch.zeros((4, 16, 2, 32))
            paged_attention(no_call, q, pages, pages,
                            torch.zeros((1, 4), dtype=torch.int32),
                            torch.ones((1,), dtype=torch.int32))
        else:
            flash_attention(no_call, q, q, q)


@pytest.mark.parametrize("hd,dtype,exc,match", [
    (40, torch.float32, ValueError, "head_dim"),
    (272, torch.float32, ValueError, "head_dim"),
    (32, torch.float16, TypeError, "dtype"),
])
def test_cuda_launcher_argument_checks(hd, dtype, exc, match):
    q = torch.zeros((1, 2, 64, hd), dtype=dtype)
    with pytest.raises(exc, match=match):
        flash_attention(None, q, q, q)


def _slot_cache(rng, b, t, nkv, hd, lengths):
    kc = _np32(rng, b, t, nkv, hd)
    vc = _np32(rng, b, t, nkv, hd)
    j = np.arange(t)[None]
    kv_pos = np.where(j < lengths[:, None], j, -1).astype(np.int32)
    return kc, vc, kv_pos


def test_decode_through_pages_equals_dense_attention():
    """Paged decode over a slot cache with block table ``b*T/bs + arange``
    and length ``pos + 1`` equals the masked dense-cache attention."""
    b, nh, nkv, hd = 3, 4, 2, 32
    t = 4 * DECODE_PAGE
    rng = np.random.default_rng(3)
    pos = np.array([0, 17, t - 1], np.int32)
    kc, vc, kv_pos = _slot_cache(rng, b, t, nkv, hd, pos + 1)
    q = _np32(rng, b, 1, nh, hd)
    dense_j = jax_gqa_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        q_positions=jnp.asarray(pos)[:, None],
        kv_positions=jnp.asarray(kv_pos), kv_valid=jnp.asarray(kv_pos) >= 0,
    )
    qt, kt, vt, kpt, post = (torch.from_numpy(a)
                             for a in (q, kc, vc, kv_pos, pos))
    dense_t = gqa_attention(qt, kt, vt, q_positions=post[:, None],
                            kv_positions=kpt, kv_valid=kpt >= 0)
    check_slot_contiguous(kpt, post)
    paged = _decode_attention(qt, kt, vt, post)
    np.testing.assert_allclose(paged.numpy(), np.asarray(dense_j), **TOL)
    np.testing.assert_allclose(paged.numpy(), dense_t.numpy(), **TOL)


def test_decode_attention_needs_whole_pages():
    x = torch.zeros((1, DECODE_PAGE + 1, 2, 32))
    with pytest.raises(ValueError, match="page"):
        _decode_attention(torch.zeros((1, 1, 4, 32)), x, x,
                          torch.zeros((1,), dtype=torch.int32))


@pytest.mark.parametrize("hole", ["gap", "stale_ahead_ok"])
def test_check_slot_contiguous(hole):
    t = 8
    kv_pos = torch.tensor([[0, 1, 2, 3, -1, -1, -1, -1],
                           [0, 1, 2, -1, -1, -1, -1, -1]], dtype=torch.int32)
    pos = torch.tensor([3, 2], dtype=torch.int32)
    check_slot_contiguous(kv_pos, pos)
    if hole == "gap":
        kv_pos[1, 1] = -1
        with pytest.raises(RuntimeError, match=r"\[1\]"):
            check_slot_contiguous(kv_pos, pos)
    else:
        # rows past pos may hold any position beyond pos (masked by the
        # causal rule) without breaking the precondition
        kv_pos[0, 5] = 6
        check_slot_contiguous(kv_pos[None].expand(2, 2, t), pos)
