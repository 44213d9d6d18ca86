"""The dense decode block's fused glue on the CPU: each wrapper's plain
branch (``kernels/ref.py``) against the composition of ``models/layers.py``
and ``models/transformer.py`` that its kernel replaces, bit for bit; the
fused block and a whole fused decode step against the composed ones, bit
for bit, with the fused path forced on CPU tensors; and the dispatch
predicate that keeps ring caches, DTensors, ``meta`` and the CPU on the
composed path.

The CUDA kernels themselves need the card: ``chip_smoke.py`` phase 3
holds them against these plain versions there.
"""

import types
from unittest import mock

import pytest
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.kernels import decode_glue, ops
from repro_torch.models import transformer
from repro_torch.models.layers import apply_rope, rms_norm, rope_tables
from repro_torch.models.transformer import (
    Model,
    _dense_block_decode_fused,
    dense_block_decode,
    fused_decode_path,
    update_cache,
    update_pos,
)

DTYPES = [torch.float32, torch.bfloat16]
THETA = 10_000.0
#: (B, T, n_kv, qpk): n_kv 8 and qpk 4 as granite-3-2b and h2o-danube-1.8b
B, T, N_KV, QPK = 3, 16, 8, 4


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()
    yield
    assert [w.launches for w in ops.COUNTED] == [0] * len(ops.COUNTED)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen).to(dtype)


def _eq(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 80])
def test_rms_norm_plain_branch_is_the_composition(dtype, d):
    gen = torch.Generator().manual_seed(d)
    x, r = (_randn(gen, B, 1, d, dtype=dtype) * 3 for _ in range(2))
    w = 1 + 0.1 * _randn(gen, d)
    assert _eq(ops.fused_rms_norm(x, w, 1e-5), rms_norm(x, w, 1e-5))
    total, normed = ops.fused_add_rms_norm(x, r, w, 1e-5)
    assert _eq(total, x + r)
    assert _eq(normed, rms_norm(x + r, w, 1e-5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("pos", [[0, 5, 14], [T - 1, T, T + 700]],
                         ids=["inside", "clamped"])
def test_rope_kv_write_plain_branch_is_the_composition(dtype, hd, pos):
    """RoPE of q and k (``attention_qkv``), ``update_cache`` of k and v
    and ``update_pos`` at the decode token, against one call; positions
    inside the cache and at or past its last row (written at row T-1)."""
    gen = torch.Generator().manual_seed(hd)
    nh = N_KV * QPK
    q = _randn(gen, B, 1, nh, hd, dtype=dtype)
    k, v = (_randn(gen, B, 1, N_KV, hd, dtype=dtype) for _ in range(2))
    k_cache, v_cache = (_randn(gen, B, T, N_KV, hd, dtype=dtype)
                        for _ in range(2))
    kv_pos = torch.randint(-1, T, (B, T), generator=gen, dtype=torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32)
    want_caches = [c.clone() for c in (k_cache, v_cache, kv_pos)]
    want_q = apply_rope(q, pos[:, None], THETA)
    update_cache(want_caches[0], apply_rope(k, pos[:, None], THETA), pos)
    update_cache(want_caches[1], v, pos)
    update_pos(want_caches[2], pos, 1)
    got = ops.rope_kv_write(q, k, v, *rope_tables(pos[:, None], hd, THETA),
                            pos, k_cache, v_cache, kv_pos)
    assert got.shape == (B, nh, hd) and got.is_contiguous()
    assert _eq(got, want_q[:, 0])
    for have, want in zip((k_cache, v_cache, kv_pos), want_caches):
        assert _eq(have, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_mul_plain_branch_is_the_composition(dtype):
    gen = torch.Generator().manual_seed(7)
    a, b = (_randn(gen, B, 1, 96, dtype=dtype) * 4 for _ in range(2))
    assert _eq(ops.silu_mul(a, b), F.silu(a) * b)


def _cfg(arch, dtype, **over):
    """A reduced config at the arch's q-per-kv ratio and a head dim of the
    kernels' (64 or 80), whose window (if any) lies past the test cache."""
    full = get_config(arch)
    return full.reduced(
        head_dim=over.pop("head_dim", full.head_dim), n_heads=8,
        n_kv_heads=8 // min(full.n_heads // full.n_kv_heads, 4),
        dtype="bfloat16" if dtype == torch.bfloat16 else "float32", **over)


ARCHS = [("granite-3-2b", {}), ("h2o-danube-1.8b", {}),
         ("mixtral-8x7b", {"head_dim": 64}),
         ("zamba2-2.7b", {"head_dim": 64})]


def _filled_cache(model, params, pos, gen):
    """A cache of random rows, each slot's ``kv_pos`` contiguous up to its
    position, as the engine keeps it."""
    cache = model.init_cache(params, len(pos), T)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=gen))
    j = torch.arange(T, dtype=torch.int32)
    cache["kv_pos"].copy_(torch.where(j[None] < pos[:, None], j[None], -1))
    return cache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,over", ARCHS[:3],
                         ids=[a for a, _ in ARCHS[:3]])
def test_fused_block_equals_composed_block(dtype, arch, over):
    """``_dense_block_decode_fused`` (the wrappers' plain branches) gives the
    composed block's output and cache writes bit for bit: dense at hd 64
    and 80, and the MoE, whose feed-forward stays ``moe_mlp``."""
    cfg = _cfg(arch, dtype, **over)
    model = Model(cfg, device="cpu")
    params = model.init(seed=3)
    lp = model.layer_params(params)[0]
    gen = torch.Generator().manual_seed(5)
    pos = torch.tensor([2, 9, T - 1], dtype=torch.int32)
    x = _randn(gen, 3, 1, cfg.d_model, dtype=dtype)
    caches = []
    for _ in range(2):
        c = _filled_cache(model, params, pos, torch.Generator().manual_seed(6))
        caches.append((c["k"][0], c["v"][0], c["kv_pos"][0]))
    want = dense_block_decode(lp, x, pos, *caches[0], cfg, False)
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    got = _dense_block_decode_fused(lp, x, pos, *caches[1], cfg, None, rope)
    for have, ref in zip(got, want):
        assert _eq(have, ref)


GLUE = ("fused_rms_norm", "fused_add_rms_norm", "rope_kv_write",
        "silu_mul")


def _counting(fn, name, calls):
    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)
    return counted


@pytest.mark.parametrize("arch,over", ARCHS, ids=[a for a, _ in ARCHS])
def test_fused_decode_step_equals_composed_step(monkeypatch, arch, over):
    """A whole ``Model.decode`` with the fused path forced on CPU tensors
    (the step's rotary tables built once and handed to every layer, the
    hybrid's shared block included) gives the composed step's logits and
    caches bit for bit, over three steps, each glue wrapper called once a
    layer and step (``silu_mul`` not in the MoE)."""
    cfg = _cfg(arch, torch.bfloat16, **over)
    model = Model(cfg, device="cpu")
    params = model.init(seed=4)
    pos0 = torch.tensor([1, 6, 11], dtype=torch.int32)
    runs, calls = [], {}
    for fused in (False, True):
        if fused:
            monkeypatch.setattr(transformer, "fused_decode_path",
                                lambda *args: True)
            for name in GLUE:
                monkeypatch.setattr(transformer, name,
                                    _counting(getattr(transformer, name),
                                              name, calls))
        cache = _filled_cache(model, params, pos0,
                              torch.Generator().manual_seed(8))
        tokens = torch.tensor([[3], [7], [11]], dtype=torch.int32)
        logits = []
        for i in range(3):
            out, cache = model.decode(params, cache, tokens, pos0 + i)
            logits.append(out)
            tokens = out[:, :, :cfg.vocab].argmax(-1).to(torch.int32)
        runs.append((logits, cache))
    (want_logits, want_cache), (got_logits, got_cache) = runs
    layers = (cfg.n_layers // cfg.attn_every if cfg.kind == "hybrid"
              else cfg.n_layers)
    assert calls == {name: 3 * layers for name in GLUE
                     if name != "silu_mul" or not cfg.is_moe}
    for have, ref in zip(got_logits, want_logits):
        assert _eq(have, ref)
    for key in want_cache:
        assert _eq(got_cache[key], want_cache[key])


def test_dispatch_predicate_takes_only_plain_cuda_full_caches():
    """Each condition alone sends the block to the composed path: a ring,
    no rotary positions, a DTensor, a CPU tensor, a meta tensor."""
    cfg = get_config("granite-3-2b")
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert fused_decode_path(card, card, cfg, ring=False)
    assert not fused_decode_path(card, card, cfg, ring=True)
    no_rope = get_config("whisper-tiny")
    assert not fused_decode_path(card, card, no_rope, ring=False)
    dt = mock.MagicMock(spec=DTensor)
    dt.device = torch.device("cuda")
    assert not fused_decode_path(dt, card, cfg, ring=False)
    assert not fused_decode_path(card, dt, cfg, ring=False)
    for device in ("cpu", "meta"):
        other = torch.zeros(1, device=device)
        assert not fused_decode_path(other, other, cfg, ring=False)


@pytest.mark.parametrize("arch,cache_len,device", [
    ("granite-3-2b", T, "cpu"), ("granite-3-2b", T, "meta"),
    ("h2o-danube-1.8b", 64, "cpu")], ids=["full", "meta", "ring"])
def test_composed_paths_launch_no_glue_kernel(arch, cache_len, device):
    """A decode step over a full cache on the CPU and on ``meta`` tensors,
    and over a ring on the CPU (reduced h2o-danube's 64-token window as
    the cache), counts no launch of any wrapper (checked by the fixture;
    on meta a wrapper would try to launch and raise)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device=device)
    params = model.init(seed=1)
    cache = model.init_cache(params, 2, cache_len)
    pos = torch.tensor([0, 3], dtype=torch.int32, device=device)
    logits, _ = model.decode(params, cache,
                             torch.tensor([[1], [2]], device=device), pos)
    assert logits.shape == (2, 1, cfg.vocab)
    if device == "cpu":
        assert (cache["kv_pos"][:, 1, 3] == 3).all()


@pytest.mark.parametrize("d,rows,want", [
    (2048, 64, (32, 1)), (2560, 256, (32, 1)), (2048, 16, (32, 1)),
    (2048, 8, (64, 1)), (2048, 1, (512, 1)), (4096, 4, (128, 1)),
    (7168, 2, (256, 1)), (1024, 1, (256, 1)), (64, 3, (64, 0)),
    (100, 600, (32, 0)), (20, 1, (16, 0)), (128, 64, (32, 1))])
def test_reduce_lanes_follow_pytorchs_reduction_config(d, rows, want):
    """The lanes a row and the grouped reads of PyTorch's CUDA mean over
    the last dim (ATen's ``setReduceConfig``: 512 threads a block, rows
    of 32 lanes while the block holds up to 16 of them, wider when fewer
    rows; groups of four from 128 elements), which the norm kernel's
    order of addition follows."""
    assert decode_glue.reduce_lanes(d, rows) == want


def test_reset_zeroes_every_counter():
    for i, w in enumerate(ops.COUNTED):
        ops._count(w)
        assert w.launches == 1
    ops.reset_launch_counts()
