"""The port's kernels on the CPU: their plain versions against the JAX
package's Pallas kernels run in interpret mode (as ``test_kernels.py`` runs
them), the wrappers' CPU dispatch and launch counters, the argument checks
of the CUDA launchers, and the decode-through-pages wiring.

Tolerance: 2e-5 absolute and relative at float32 and 3e-2 at bfloat16, the
tolerances of ``tests/test_kernels.py``.  The CUDA kernels themselves need
the card: ``chip_smoke.py`` holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mlstm_chunk_kernel
from repro.kernels import ops as jops
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch.kernels import decode_glue, ops
from repro_torch.kernels.chunk_attention import chunk_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.layers import gqa_attention
from repro_torch.models.transformer import (
    DECODE_PAGE,
    _decode_attention,
    check_slot_contiguous,
    decode_page,
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
        # hd 80: h2o-danube's GQA 4:1 with a window that cuts a 64-token
        # tile, S past the window; zamba2's MHA
        (1, 320, 4, 1, 80, 64, 100),
        (2, 128, 4, 4, 80, 64, 0),
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
        window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.flash_prefill.launches == 0


def test_flash_prefill_rejects_misaligned_seq():
    q = torch.zeros((1, 100, 2, 64))
    with pytest.raises(ValueError):
        ops.flash_prefill(q, q, q)
    with pytest.raises(ValueError):
        jops.flash_prefill(jnp.zeros((1, 100, 2, 64)), jnp.zeros((1, 100, 2, 64)),
                           jnp.zeros((1, 100, 2, 64)), block_q=64,
                           block_k=64, interpret=True)


def _no_call(*_):
    raise AssertionError("the kernel entry point must not be reached")


def _glue_call(launcher, dtype=torch.float32, hd=64, other=None):
    """One decode token's call of a decode-glue launcher on CPU tensors
    (B 1, 4/2 heads); ``other`` is the dtype of its second float input."""
    other = other or dtype
    x, w = torch.zeros((1, 1, 32), dtype=dtype), torch.ones(32)
    if launcher == "rms_norm":
        return decode_glue.rms_norm(_no_call, x, w, 1e-5)
    if launcher == "add_rms_norm":
        return decode_glue.rms_norm(_no_call, x, w, 1e-5, x.to(other))
    if launcher == "silu_mul":
        return decode_glue.silu_mul(_no_call, x, x.to(other))
    q = torch.zeros((1, 1, 4, hd), dtype=dtype)
    k = torch.zeros((1, 1, 2, hd), dtype=dtype)
    cache = torch.zeros((1, 8, 2, hd), dtype=other)
    tab = torch.zeros((1, 1, 1, hd // 2))
    pos = torch.zeros((1,), dtype=torch.int32)
    return decode_glue.rope_kv_write(
        _no_call, q, k, k, tab, tab, pos, cache, cache,
        torch.zeros((1, 8), dtype=torch.int32))


GLUE_LAUNCHERS = ["rms_norm", "add_rms_norm", "rope_kv_write", "silu_mul"]


def _chunk_call(dtype=torch.bfloat16, hd=64):
    """A chunk of 64 queries against a 128-row cache, on CPU tensors."""
    q = torch.zeros((1, 64, 4, hd), dtype=dtype)
    k = torch.zeros((1, 128, 2, hd), dtype=dtype)
    return chunk_attention(_no_call, q, k, k, torch.arange(64)[None],
                           torch.zeros((1, 128), dtype=torch.int32))


@pytest.mark.parametrize("launcher",
                         ["paged", "flash", "mlstm", "mlstm_tensor_core"]
                         + GLUE_LAUNCHERS + ["chunk"])
def test_cuda_launchers_refuse_cpu_tensors(launcher):
    """The CUDA path never quietly runs on CPU tensors: the launchers check
    the device before touching the C entry point (which is never called
    here).  ``mlstm_tensor_core`` gives the mLSTM launcher what its rule
    sends to the two tensor-core passes (bf16, hd 64, 64-token chunks);
    the decode glue's launchers get one decode token's tensors."""
    no_call = _no_call
    q = torch.zeros((1, 2, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        if launcher in GLUE_LAUNCHERS:
            _glue_call(launcher, torch.bfloat16)
        elif launcher == "chunk":
            _chunk_call()
        elif launcher == "paged":
            pages = torch.zeros((4, 16, 2, 32))
            paged_attention(no_call, q, pages, pages,
                            torch.zeros((1, 4), dtype=torch.int32),
                            torch.ones((1,), dtype=torch.int32))
        elif launcher == "flash":
            flash_attention(no_call, q, q, q)
        elif launcher == "mlstm":
            g = torch.zeros((1, 2, 2))
            mlstm_chunk(no_call, q, q, q, g, g)
        else:
            x = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
            g = torch.zeros((1, 2, 64))
            mlstm_chunk(no_call, x, x, x, g, g, chunk=64)


@pytest.mark.parametrize("launcher,hd,dtype,other,exc,match", [
    pytest.param("flash", 40, torch.float32, None, ValueError, "head_dim",
                 id="40-dtype0-ValueError-head_dim"),
    pytest.param("flash", 272, torch.float32, None, ValueError, "head_dim",
                 id="272-dtype1-ValueError-head_dim"),
    pytest.param("flash", 32, torch.float16, None, TypeError, "dtype",
                 id="32-dtype2-TypeError-dtype"),
    pytest.param("rope_kv_write", 40, torch.bfloat16, None, ValueError,
                 "head_dim", id="rope_kv_write-head_dim"),
    pytest.param("rope_kv_write", 64, torch.float16, None, TypeError,
                 "dtype", id="rope_kv_write-dtype"),
    pytest.param("rope_kv_write", 64, torch.bfloat16, torch.float32,
                 TypeError, "mixed", id="rope_kv_write-mixed"),
    pytest.param("rms_norm", 64, torch.float16, None, TypeError, "dtype",
                 id="rms_norm-dtype"),
    pytest.param("add_rms_norm", 64, torch.bfloat16, torch.float32,
                 TypeError, "mixed", id="add_rms_norm-mixed"),
    pytest.param("silu_mul", 64, torch.bfloat16, torch.float32, TypeError,
                 "mixed", id="silu_mul-mixed"),
    pytest.param("chunk", 96, torch.bfloat16, None, ValueError, "head_dim",
                 id="chunk-head_dim"),
    pytest.param("chunk", 64, torch.float32, None, TypeError, "dtype",
                 id="chunk-float32"),
    pytest.param("chunk", 64, torch.float16, None, TypeError, "dtype",
                 id="chunk-float16"),
])
def test_cuda_launcher_argument_checks(launcher, hd, dtype, other, exc,
                                       match):
    """Bad head dims and dtypes, and mixed dtypes, are refused before the
    device is looked at (the tensors here are on the CPU)."""
    with pytest.raises(exc, match=match):
        if launcher == "flash":
            q = torch.zeros((1, 2, 64, hd), dtype=dtype)
            flash_attention(None, q, q, q)
        elif launcher == "chunk":
            _chunk_call(dtype, hd)
        else:
            _glue_call(launcher, dtype, hd, other)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,s,hd,chunk",
    [
        (2, 2, 64, 32, 16),
        (1, 3, 128, 64, 32),
        (1, 1, 96, 128, 32),     # non-power-of-two chunk count
        (2, 1, 64, 256, 64),     # xlstm-350m head_dim, single chunk
    ],
)
def test_mlstm_chunk_plain_matches_pallas(dtype, b, h, s, hd, chunk):
    """The plain chunkwise mLSTM at the empty state against the Pallas
    kernel, on the shapes of ``tests/test_kernels.py``."""
    rng = np.random.default_rng(4)
    q, k, v = (_np32(rng, b, h, s, hd) * 0.5 for _ in range(3))
    i_raw = _np32(rng, b, h, s) * 0.5
    log_f = -np.logaddexp(0.0, -(_np32(rng, b, h, s) * 0.5 + 2.0))
    args = (q, k, v, i_raw, log_f.astype(np.float32))
    want = mlstm_chunk_kernel(
        *(jnp.asarray(a).astype(dtype) for a in args), chunk=chunk,
        interpret=True)
    got, (c, n, m) = ops.mlstm_chunk(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in args),
        chunk=chunk)
    assert got.dtype == getattr(torch, dtype)
    assert (c.shape, n.shape, m.shape) == ((b, h, hd, hd), (b, h, hd), (b, h))
    tol = TOL if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    assert ops.mlstm_chunk.launches == 0


def test_mlstm_chunk_any_length_and_state():
    """A chunk that does not divide S masks the last chunk: the output and
    the state handed on equal those of one chunk per token and of running
    the two halves of the sequence one after the other."""
    b, h, s, hd = 1, 2, 50, 32
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_np32(rng, b, h, s, hd)) for _ in range(3))
    i_raw = torch.from_numpy(_np32(rng, b, h, s))
    log_f = torch.nn.functional.logsigmoid(
        torch.from_numpy(_np32(rng, b, h, s)) + 2.0)
    whole, st = ops.mlstm_chunk(q, k, v, i_raw, log_f, chunk=16)
    steps, st1 = ops.mlstm_chunk(q, k, v, i_raw, log_f, chunk=1)
    np.testing.assert_allclose(whole.numpy(), steps.numpy(), **TOL)
    cut = 23
    head, mid = ops.mlstm_chunk(
        *(x[:, :, :cut] for x in (q, k, v, i_raw, log_f)), chunk=16)
    tail, st2 = ops.mlstm_chunk(
        *(x[:, :, cut:] for x in (q, k, v, i_raw, log_f)), mid, chunk=16)
    np.testing.assert_allclose(torch.cat([head, tail], 2).numpy(),
                               whole.numpy(), **TOL)
    for a, b1, b2 in zip(st, st1, st2):
        np.testing.assert_allclose(b1.numpy(), a.numpy(), **TOL)
        np.testing.assert_allclose(b2.numpy(), a.numpy(), **TOL)


@pytest.mark.parametrize("chunk", [0, 65])
def test_mlstm_chunk_rejects_chunk_outside_its_tile(chunk):
    """On the CPU as on the card: the kernel's tile holds 1..64 tokens."""
    x = torch.zeros((1, 1, 8, 32))
    g = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError, match="chunk"):
        ops.mlstm_chunk(x, x, x, g, g, chunk=chunk)


def _slot_cache(rng, b, t, nkv, hd, lengths):
    kc = _np32(rng, b, t, nkv, hd)
    vc = _np32(rng, b, t, nkv, hd)
    j = np.arange(t)[None]
    kv_pos = np.where(j < lengths[:, None], j, -1).astype(np.int32)
    return kc, vc, kv_pos


def _paged_and_dense(t):
    """Decode through pages over a T-row slot cache, and the masked dense
    attention of JAX and of the port over the same cache."""
    b, nh, nkv, hd = 3, 4, 2, 32
    rng = np.random.default_rng(3)
    pos = np.array([0, min(17, t - 1), t - 1], np.int32)
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


def test_decode_through_pages_equals_dense_attention():
    """Paged decode over a slot cache with block table ``b*T/bs + arange``
    and length ``pos + 1`` equals the masked dense-cache attention."""
    _paged_and_dense(4 * DECODE_PAGE)


def test_decode_attention_needs_whole_pages():
    """A cache length that ``DECODE_PAGE`` does not divide is viewed as
    whole pages of ``decode_page(T)`` tokens (1 at the primes 17 and 97, 10
    at 100) and decodes to the masked dense attention."""
    for t, bs in ((DECODE_PAGE + 1, 1), (97, 1), (100, 10)):
        assert decode_page(t) == bs
        _paged_and_dense(t)


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
