"""The redesigned attention kernels' rules, on the CPU.

* ``ref.paged_attention_split_ref`` computes what the split paged-decode
  kernel computes (partial softmax states over contiguous page ranges,
  merged); it is held against the Pallas kernel in interpret mode and
  against ``paged_attention_ref``;
* ``split_plan`` covers every page once with at most 8 blocks;
* ``flash_path`` picks the tensor-core kernel exactly for bf16 at hd 32,
  64 or 128 with S a multiple of 64;
* both new designs' shared memory fits a Hopper block for every head dim
  that ``chip_smoke.py`` checks;
* the decode step builds its page table once and hands it to every layer,
  at any cache length: 16-token pages wherever 16 divides it, as before,
  else the largest page size that divides it.

Tolerance: 2e-5 absolute and relative at float32, the tolerance of
``tests/test_kernels.py``.  The CUDA kernels themselves need the card:
``chip_smoke.py`` holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_path
from repro_torch.kernels.flash_attention import smem_bytes as flash_smem
from repro_torch.kernels.flash_attention import tc_heads
from repro_torch.kernels.paged_attention import (
    MAX_SPLIT,
    MIN_TOKENS_PER_SPLIT,
    split_plan,
)
from repro_torch.kernels.paged_attention import smem_bytes as paged_smem
from repro_torch.models import Model
from repro_torch.models import transformer

TOL = dict(atol=2e-5, rtol=2e-5)
#: shared memory one Hopper block may use (bytes)
BLOCK_SMEM = 232_448


def _np32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _split_inputs(seed, b, nh, nkv, hd, bs, pages, max_pages, lengths):
    rng = np.random.default_rng(seed)
    q = _np32(rng, b, nh, hd)
    kp = _np32(rng, pages, bs, nkv, hd)
    vp = _np32(rng, pages, bs, nkv, hd)
    tables = rng.integers(0, pages, (b, max_pages)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _split_vs_pallas(q, kp, vp, tables, lengths, bs, n_split):
    want = jops.paged_gqa_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
        block_size=bs, interpret=True,
    )
    b, nh, hd = q.shape
    nkv = kp.shape[2]
    qt, kpt, vpt, tt, lt = (torch.from_numpy(a)
                            for a in (q, kp, vp, tables, lengths))
    qg = (qt * hd ** -0.5).reshape(b, nkv, nh // nkv, hd)
    got = ref.paged_attention_split_ref(qg, kpt, vpt, tt, lt, n_split)
    np.testing.assert_allclose(got.reshape(b, nh, hd).numpy(),
                               np.asarray(want), **TOL)
    return qg, kpt, vpt, tt, lt, got


@pytest.mark.parametrize(
    "b,nh,nkv,hd,bs,pages,max_pages",
    [
        (1, 4, 4, 64, 16, 8, 4),       # MHA
        (3, 8, 2, 64, 16, 32, 6),      # GQA 4:1
        (2, 8, 1, 128, 16, 16, 8),     # MQA
        (2, 6, 2, 80, 16, 16, 5),      # head_dim 80
        (1, 4, 2, 256, 32, 8, 3),      # wide heads, bs 32
    ],
)
def test_split_ref_matches_pallas_and_plain(b, nh, nkv, hd, bs, pages,
                                            max_pages):
    """The sweep of ``tests/test_kernels.py``, at the planner's split and
    at every split up to ``max_pages`` ranges."""
    lengths = np.linspace(1, max_pages * bs, b).astype(np.int32)
    inputs = _split_inputs(0, b, nh, nkv, hd, bs, pages, max_pages, lengths)
    n_plan, _ = split_plan(max_pages)
    for n_split in sorted({n_plan, *range(1, max_pages + 1)}):
        qg, kpt, vpt, tt, lt, got = _split_vs_pallas(*inputs, bs, n_split)
        plain = ref.paged_attention_ref(qg, kpt, vpt, tt, lt)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize(
    "lengths,what",
    [
        ([1, 2, 3], "length 1 and later ranges empty"),
        ([64, 128, 65], "lengths on and just past a split boundary"),
        ([0, 16, 320], "length 0 gives 0"),
        ([319, 17, 4], "short sequences: most ranges empty"),
    ],
)
def test_split_ref_length_edges(lengths, what):
    """20 pages of 16 tokens split into 5 ranges of 4 pages (64 tokens)."""
    b, nh, nkv, hd, bs, pages, mp = 3, 8, 2, 64, 16, 64, 20
    inputs = _split_inputs(1, b, nh, nkv, hd, bs, pages, mp, lengths)
    qg, kpt, vpt, tt, lt, got = _split_vs_pallas(*inputs, bs, 5)
    zero = lt == 0
    if zero.any():
        assert not got[zero].any(), what
    plain = ref.paged_attention_ref(qg, kpt, vpt, tt, lt)
    np.testing.assert_allclose(got[~zero].numpy(), plain[~zero].numpy(),
                               **TOL)


@pytest.mark.parametrize("max_pages", [1, 2, 3, 4, 5, 7, 8, 20, 31, 32, 33,
                                       64, 100, 257, 2048])
def test_split_plan_covers_every_page_once(max_pages):
    n_split, per = split_plan(max_pages)
    assert 1 <= n_split <= MAX_SPLIT
    covered = [p for r in range(n_split)
               for p in range(r * per, min((r + 1) * per, max_pages))]
    assert covered == list(range(max_pages))
    # no block's range lies wholly past the table
    assert (n_split - 1) * per < max_pages


@pytest.mark.parametrize("max_pages,bs,plan", [
    (32, 16, (4, 8)),     # cache 512 in 16-token pages: 8 pages a block
    (6, 16, (1, 6)),      # cache 96: one block
    (64, 16, (8, 8)),
    (10, 10, (1, 10)),    # cache 100 in 10-token pages: 100 tokens, one
    (97, 1, (1, 97)),     # cache 97 in 1-token pages: one block
    (100, 10, (8, 13)),   # cache 1000: 8 blocks of 130 tokens
    (256, 1, (2, 128)),   # 128 one-token pages a block, as 8 pages of 16
])
def test_split_plan_counts_tokens(max_pages, bs, plan):
    """Blocks walk at least ``MIN_TOKENS_PER_SPLIT`` tokens whatever the
    page size, so that a cache viewed in smaller pages splits as the same
    tokens in 16-token pages do; at 16 tokens a page that is 8 pages."""
    assert split_plan(max_pages, bs) == plan
    assert MIN_TOKENS_PER_SPLIT == 8 * 16


def test_split_plan_at_granite_decode():
    """cache_len 512 in 16-token pages: 4 blocks of 8 pages per (slot, kv
    head), 8 x 8 x 4 = 256 blocks at max_batch 8."""
    cfg = get_config("granite-3-2b")
    assert split_plan(512 // transformer.DECODE_PAGE) == (4, 8)
    assert 8 * cfg.n_kv_heads * split_plan(32)[0] == 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 128, 256])
@pytest.mark.parametrize("s", [64, 100, 128, 448, 512])
def test_flash_path_rule(dtype, hd, s):
    want = ("tensor_core" if dtype == torch.bfloat16
            and hd in (32, 64, 128) and s % 64 == 0 else "cuda_core")
    assert flash_path(dtype, hd, s) == want


@pytest.mark.parametrize("qpk,hd,heads", [
    (4, 64, 4), (4, 32, 4), (4, 128, 2), (2, 64, 2), (1, 64, 1), (3, 64, 1),
    (8, 128, 2), (1, 128, 1),
])
def test_tc_heads(qpk, hd, heads):
    assert tc_heads(qpk, hd) == heads


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("qpk", [1, 2, 4, 8])
def test_flash_smem_fits_a_block(hd, qpk):
    for path in ("tensor_core", "cuda_core"):
        assert 0 < flash_smem(hd, path=path, qpk=qpk) <= BLOCK_SMEM
    # the granite block: two buffers of 4 q tiles and four K/V stages, of
    # 8 KB tiles
    if (hd, qpk) == (64, 4):
        assert flash_smem(hd, path="tensor_core", qpk=qpk) == (
            1024 + 16 * 8192 + 96)


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("qpk", [1, 2, 4, 8])
def test_paged_smem_fits_a_block(hd, qpk):
    assert 0 < paged_smem(qpk, hd) <= BLOCK_SMEM


def test_decode_builds_the_page_table_once_per_step(monkeypatch):
    """``Model.decode`` builds ``slot_pages`` once and every layer's paged
    decode takes that table; the logits equal those of a step that builds
    the table in each layer."""
    cfg = get_config("granite-3-2b").reduced(n_layers=3)
    model = Model(cfg, device="cpu", debug_checks=True)
    params = model.init(seed=0)
    b, s, t = 2, 24, 64
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=t)
    nxt = torch.randint(0, cfg.vocab, (b, 1), generator=gen)
    pos = torch.full((b,), s, dtype=torch.int32)

    calls, tables_seen = [], []
    real_pages = transformer.slot_pages
    real_paged = transformer.paged_gqa_decode

    def counting_pages(*args):
        calls.append(args)
        return real_pages(*args)

    def seeing_paged(q, kp, vp, tables, lengths, **kw):
        tables_seen.append(tables)
        return real_paged(q, kp, vp, tables, lengths, **kw)

    monkeypatch.setattr(transformer, "slot_pages", counting_pages)
    monkeypatch.setattr(transformer, "paged_gqa_decode", seeing_paged)
    cache_a = {k: v.clone() for k, v in cache.items()}
    logits, _ = model.decode(params, cache_a, nxt, pos)
    assert len(calls) == 1
    assert len(tables_seen) == cfg.n_layers
    assert all(t is tables_seen[0] for t in tables_seen)

    # the same step with the table built inside each layer
    cache_b = {k: v.clone() for k, v in cache.items()}
    x = model._embed(params, nxt, pos[:, None])
    for l, lp in enumerate(model.layer_params(params)):
        x, _, _, _ = transformer.dense_block_decode(
            lp, x, pos, cache_b["k"][l], cache_b["v"][l],
            cache_b["kv_pos"][l], cfg, False)
    assert len(calls) == 1 + cfg.n_layers
    np.testing.assert_allclose(logits.numpy(),
                               model._logits(params, x).numpy(), **TOL)
    for key in ("k", "v", "kv_pos"):
        assert torch.equal(cache_a[key], cache_b[key])


@pytest.mark.parametrize("t,bs", [(96, 16), (512, 16), (160, 16), (100, 10),
                                  (97, 1), (17, 1), (50, 10)])
def test_decode_pages_at_any_cache_len(monkeypatch, t, bs):
    """One decode step at cache length T: every layer's paged decode gets
    the slot cache as ``T/bs`` whole pages of ``bs`` tokens, the table
    ``arange(B*T/bs)`` and lengths ``pos + 1`` (for a multiple of 16,
    exactly the 16-token pages of before), one launch per layer; the split
    plan takes the page count by the rule of every cache length."""
    cfg = get_config("granite-3-2b").reduced(n_layers=2)
    model = Model(cfg, device="cpu", debug_checks=True)
    params = model.init(seed=0)
    b = 2
    cache = model.init_cache(params, b, t)
    pos = torch.tensor([0, t - 1], dtype=torch.int32)
    seen = []
    real_paged = transformer.paged_gqa_decode

    def seeing_paged(q, kp, vp, tables, lengths, **kw):
        seen.append((tuple(kp.shape), kw["block_size"], tables, lengths))
        return real_paged(q, kp, vp, tables, lengths, **kw)

    monkeypatch.setattr(transformer, "paged_gqa_decode", seeing_paged)
    # rows 0 .. pos of each slot valid, as the engine keeps them
    j = torch.arange(t, dtype=torch.int32)
    cache["kv_pos"][:] = torch.where(j <= pos[:, None], j, -1)
    model.decode(params, cache, torch.zeros((b, 1), dtype=torch.int32), pos)
    assert transformer.decode_page(t) == bs
    assert len(seen) == cfg.n_layers
    n_pages = t // bs
    for shape, block_size, tables, lengths in seen:
        assert shape == (b * n_pages, bs, cfg.n_kv_heads, cfg.head_dim)
        assert block_size == bs
        assert torch.equal(tables, torch.arange(
            b * n_pages, dtype=torch.int32).view(b, n_pages))
        assert torch.equal(lengths, pos + 1)
    n_split, per = split_plan(n_pages, bs)
    assert n_split == min(MAX_SPLIT, -(-t // MIN_TOKENS_PER_SPLIT))
    assert (n_split - 1) * per < n_pages <= n_split * per


def test_every_cache_len_views_as_whole_pages():
    for t in range(1, 600):
        bs = transformer.decode_page(t)
        assert t % bs == 0 and 1 <= bs <= transformer.DECODE_PAGE
        assert (bs == transformer.DECODE_PAGE) == (t % 16 == 0)
