"""Chunked prefill's attention on the CPU: the ``ops.chunk_attention``
wrapper's plain branch against ``attention_any`` as ``dense_block_chunk``
calls it, bit for bit, and against the kernel's contract written out
here; the predicate that routes a chunk step to the kernel; a chunk step
and a whole ``prefill_chunked`` with the kernel's route forced on CPU
tensors, bit for bit; and no launch counted on the CPU.

The CUDA kernel needs the card: ``chip_smoke.py`` phase 3 holds it against
``attention_any`` there.
"""

import types
from unittest import mock

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.chunk_attention import chunk_attention, chunk_path
from repro_torch.models import transformer
from repro_torch.models.layers import attention_any
from repro_torch.models.transformer import (
    Model,
    chunk_attention_path,
    dense_block_chunk,
)

#: granite-3-2b's and h2o-danube-1.8b's heads
NH, N_KV = 32, 8
#: a chunk of 64 queries; the benchmark's chunks hold 512
S = 64


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()
    yield
    assert ops.chunk_attention.launches == 0


def _chunk_inputs(dtype, hd, offset, t, lens, seed=0):
    """A chunk step's inputs as ``prefill_chunked`` leaves them: the cache
    rows below offset + S hold position j where j < lens[b], the rest -1;
    K/V drawn on every row, so that masking shows."""
    gen = torch.Generator().manual_seed(seed)
    b = len(lens)
    q = torch.randn(b, S, NH, hd, generator=gen).to(dtype)
    k, v = (torch.randn(b, t, N_KV, hd, generator=gen).to(dtype)
            for _ in range(2))
    j = torch.arange(t, dtype=torch.int32)[None]
    lens = torch.tensor(lens, dtype=torch.int32)[:, None]
    kv_pos = torch.where((j < offset + S) & (j < lens), j, -1)
    positions = torch.arange(offset, offset + S)[None].expand(b, S)
    return q, k, v, positions, kv_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("offset,t", [(0, 1024), (512, 1024), (0, 2048),
                                      (512, 2048)])
@pytest.mark.parametrize("window", [0, 4096, 300])
def test_plain_branch_is_attention_any(dtype, hd, offset, t, window):
    """Ragged rows, one of them a padding row of length 1; windows off, past
    the cache and inside it (queries past position 300 lose key 0)."""
    q, k, v, positions, kv_pos = _chunk_inputs(
        dtype, hd, offset, t, [offset + S, 1, offset + 17], seed=hd + t)
    got = ops.chunk_attention(q, k, v, positions, kv_pos, window=window)
    want = attention_any(q, k, v, window=window, q_positions=positions,
                         kv_positions=kv_pos, kv_valid=kv_pos >= 0)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _contract(q, k, v, positions, kv_pos, window):
    """The kernel's contract in numpy, float64: the query at position p of
    row b attends key j iff kv_pos[b, j] >= 0, kv_pos[b, j] <= p and
    kv_pos[b, j] > p - window (window > 0); hd^-0.5 scaled scores.
    Returns the output and the (B, S) mask of queries that attend a key."""
    q, k, v = (x.double().numpy() for x in (q, k, v))
    b, s, nh, hd = q.shape
    qpk = nh // k.shape[2]
    kp = kv_pos.numpy()[:, None, :]
    qp = positions.numpy()[:, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask &= kp > qp - window
    kh = np.repeat(k, qpk, axis=2)
    vh = np.repeat(v, qpk, axis=2)
    scores = np.einsum("bshd,bthd->bhst", q, kh) * hd ** -0.5
    scores = np.where(mask[:, None], scores, -np.inf)
    m = scores.max(-1, keepdims=True)
    p = np.exp(scores - np.where(np.isfinite(m), m, 0))
    p /= np.maximum(p.sum(-1, keepdims=True), 1e-300)
    return np.einsum("bhst,bthd->bshd", p, vh), mask.any(-1)


@pytest.mark.parametrize("offset,window", [(0, 0), (512, 0), (512, 300)])
def test_plain_branch_keeps_the_kernels_contract(offset, window):
    """At float32 the plain branch is the contract on every query that
    attends a key.  A query that attends none (the padding row's past the
    window) is outside it: there the plain attention's -1e30 fill gives
    the mean of V over every cache row, where the kernel gives 0; a chunked
    prefill has no such query on a real row, since each row's key 0 is
    valid and the window starts at position 0 below its size."""
    q, k, v, positions, kv_pos = _chunk_inputs(
        torch.float32, 64, offset, 1024, [offset + S, 1], seed=3)
    got = ops.chunk_attention(q, k, v, positions, kv_pos, window=window)
    want, attends = _contract(q, k, v, positions, kv_pos, window)
    np.testing.assert_allclose(got.numpy()[attends], want[attends],
                               atol=2e-5, rtol=2e-5)
    empty = ~attends
    assert empty.any() == bool(window and offset)
    if empty.any():
        mean_v = v.double().mean(1).repeat_interleave(NH // N_KV, dim=1)
        rows = np.argwhere(empty)
        np.testing.assert_allclose(
            got.numpy()[empty],
            mean_v.numpy()[rows[:, 0]], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,hd,s,takes", [
    (torch.bfloat16, 64, 512, True), (torch.bfloat16, 80, 448, True),
    (torch.bfloat16, 32, 64, True), (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 80, 100, False), (torch.bfloat16, 96, 512, False),
    (torch.bfloat16, 256, 512, False), (torch.float32, 64, 512, False),
    (torch.float16, 64, 512, False)])
def test_chunk_path_rule(dtype, hd, s, takes):
    """The kernel's rule is the tensor-core flash kernel's: bf16, hd 32,
    64, 80 or 128, whole 64-query tiles."""
    assert chunk_path(dtype, hd, s) is takes


def _fake(device="cuda", dtype=torch.bfloat16, shape=(32, 512, NH, 80)):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 shape=shape)


def test_routing_predicate_takes_only_plain_cuda_bf16_tiles():
    """Each condition alone keeps ``attention_any``: the CPU, float32 q or
    cache, a head dim the kernel lacks, a ragged chunk, a DTensor."""
    cache = _fake(shape=(32, 1024, N_KV, 80))
    assert chunk_attention_path(_fake(), cache)
    assert not chunk_attention_path(_fake(device="cpu"), cache)
    assert not chunk_attention_path(_fake(dtype=torch.float32), cache)
    assert not chunk_attention_path(
        _fake(), _fake(dtype=torch.float32, shape=(32, 1024, N_KV, 80)))
    assert not chunk_attention_path(_fake(shape=(32, 512, NH, 96)), cache)
    assert not chunk_attention_path(_fake(shape=(32, 500, NH, 80)), cache)
    dt = mock.MagicMock(spec=DTensor)
    dt.device, dt.dtype, dt.shape = torch.device("cuda"), torch.bfloat16, (
        32, 512, NH, 80)
    assert not chunk_attention_path(dt, cache)
    assert not chunk_attention_path(_fake(), dt)
    cpu = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    assert not chunk_attention_path(cpu, cpu)


def _cfg(arch):
    """A reduced bf16 config at a head dim of the kernel's, its window
    (if any) past the test caches."""
    full = get_config(arch)
    return full.reduced(dtype="bfloat16", head_dim=full.head_dim,
                        n_heads=8, n_kv_heads=2,
                        sliding_window=full.sliding_window and 4096)


def _counting(fn, calls):
    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return fn(*args, **kwargs)
    return counted


@pytest.mark.parametrize("arch", ["granite-3-2b", "h2o-danube-1.8b"])
def test_forced_route_chunk_step_is_the_plain_step(monkeypatch, arch):
    """``dense_block_chunk`` with the kernel's route forced on CPU tensors
    calls ``chunk_attention`` (whose plain branch runs) and gives the
    plain step's output and cache writes bit for bit."""
    cfg = _cfg(arch)
    model = Model(cfg, device="cpu")
    params = model.init(seed=2)
    lp = model.layer_params(params)[0]
    gen = torch.Generator().manual_seed(4)
    b, t, offset = 3, 256, 64
    x = torch.randn(b, S, cfg.d_model, generator=gen).to(torch.bfloat16)
    lens = torch.tensor([offset + S, 1, offset + 9], dtype=torch.int32)
    positions = torch.arange(offset, offset + S)[None].expand(b, S)
    pos = torch.full((b,), offset, dtype=torch.int32)
    runs, calls = [], []
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(transformer, "chunk_attention_path",
                                lambda q, k: True)
            monkeypatch.setattr(transformer, "chunk_attention",
                                _counting(ops.chunk_attention, calls))
        cache = model.init_cache(params, b, t)
        runs.append(dense_block_chunk(lp, x, pos, positions, lens,
                                      cache["k"][0], cache["v"][0],
                                      cache["kv_pos"][0], cfg))
    assert calls == [(b, S, cfg.n_heads, cfg.head_dim)]
    for have, want in zip(runs[1], runs[0]):
        assert have.dtype == want.dtype and torch.equal(have, want)


@pytest.mark.parametrize("forced", [False, True], ids=["cpu", "forced"])
def test_prefill_chunked_routes_every_chunk_step(monkeypatch, forced):
    """A whole ``prefill_chunked`` of reduced bf16 h2o-danube-1.8b (three
    64-token chunks): on the CPU no chunk step takes the kernel's route;
    forced onto it, every layer of every chunk calls ``chunk_attention``,
    and the logits and every cache leaf equal the plain pass bit for bit.
    No launch is counted either way (the fixture)."""
    cfg = _cfg("h2o-danube-1.8b")
    model = Model(cfg, device="cpu")
    params = model.init(seed=5)
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (4, 3 * S), generator=gen)
    batch = {"tokens": tokens,
             "lens": torch.tensor([3 * S, 1, 70, 2 * S], dtype=torch.int32)}
    want_logits, want_cache = model.prefill_chunked(params, batch, 256, S)
    calls = []
    monkeypatch.setattr(transformer, "chunk_attention",
                        _counting(ops.chunk_attention, calls))
    if forced:
        monkeypatch.setattr(transformer, "chunk_attention_path",
                            lambda q, k: True)
    logits, cache = model.prefill_chunked(params, batch, 256, S)
    assert len(calls) == (3 * cfg.n_layers if forced else 0)
    assert torch.equal(logits, want_logits)
    for key in want_cache:
        assert torch.equal(cache[key], want_cache[key])


def _cpu_chunk(dtype=torch.bfloat16, hd=64, s=S):
    q = torch.zeros((1, s, 4, hd), dtype=dtype)
    k = torch.zeros((1, 128, 2, hd), dtype=dtype)
    positions = torch.arange(s)[None]
    kv_pos = torch.zeros((1, 128), dtype=torch.int32)
    return q, k, k, positions, kv_pos


@pytest.mark.parametrize("hd,dtype,s,exc,match", [
    (64, torch.bfloat16, 100, ValueError, "multiple of 64"),
    (48, torch.bfloat16, S, ValueError, "head_dim"),
    (64, torch.float32, S, TypeError, "bfloat16"),
    (64, torch.bfloat16, S, ValueError, "CUDA"),
], ids=["ragged", "head_dim", "float32", "cpu"])
def test_launcher_refuses_what_the_kernel_does_not_take(hd, dtype, s, exc,
                                                        match):
    """The launcher checks before the C entry point (never reached here):
    a ragged chunk, a head dim, a dtype, and CPU tensors."""
    def no_call(*_):
        raise AssertionError("the kernel entry point must not be reached")

    with pytest.raises(exc, match=match):
        chunk_attention(no_call, *_cpu_chunk(dtype, hd, s))
