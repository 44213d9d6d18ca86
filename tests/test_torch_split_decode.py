"""The redesigned attention kernels' rules, on the CPU.

* ``ref.paged_attention_split_ref`` computes what the split bf16
  paged-decode kernel computes (partial softmax states over each
  sequence's live tokens, dealt in 16-token tiles by ``split_tiles``,
  merged); it is held
  against the Pallas kernel in interpret mode and against
  ``paged_attention_ref`` at lengths 0 and 1, on and past page and split
  boundaries, stale ragged rows, pages of 1, 10, 16 and 32 tokens, qpk 1,
  2, 4 and 7 and hd 64, 80, 128 and 256;
* ``split_plan`` takes the split from the shapes (blocks against the SMs,
  the table's width), at most 8, and ``split_tiles`` covers every live
  token once;
* ``flash_path`` picks the tensor-core kernel exactly for bf16 at hd 32,
  64, 80 or 128 with S a multiple of 64;
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
    BLOCKS_PER_SM,
    H100_SMS,
    MAX_SPLIT,
    MIN_TOKENS_PER_SPLIT,
    heads_per_block,
    split_plan,
    split_tiles,
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
    at every split up to ``max_pages`` blocks."""
    lengths = np.linspace(1, max_pages * bs, b).astype(np.int32)
    inputs = _split_inputs(0, b, nh, nkv, hd, bs, pages, max_pages, lengths)
    groups = b * nkv * -(-(nh // nkv) // heads_per_block(nh // nkv))
    n_plan = split_plan(groups, max_pages, bs)
    for n_split in sorted({n_plan, *range(1, max_pages + 1)}):
        qg, kpt, vpt, tt, lt, got = _split_vs_pallas(*inputs, bs, n_split)
        plain = ref.paged_attention_ref(qg, kpt, vpt, tt, lt)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize(
    "lengths,what",
    [
        ([1, 2, 3], "length 1 and later blocks empty"),
        ([64, 128, 65], "lengths on and just past a split boundary"),
        ([0, 16, 320], "length 0 gives 0"),
        ([319, 17, 4], "short sequences: most blocks empty"),
        ([15, 16, 17], "on and past a page (and tile) boundary"),
        ([80, 81, 96], "5 live tiles, one a block; 6, block 0 two"),
        ([0, 0, 1], "two empty sequences beside one token"),
        ([160, 161, 319], "10 tiles, two a block; 11, block 0 three"),
    ],
)
def test_split_ref_length_edges(lengths, what):
    """20 pages of 16 tokens, each sequence's live 16-token tiles dealt
    over 5 blocks."""
    b, nh, nkv, hd, bs, pages, mp = 3, 8, 2, 64, 16, 64, 20
    inputs = _split_inputs(1, b, nh, nkv, hd, bs, pages, mp, lengths)
    qg, kpt, vpt, tt, lt, got = _split_vs_pallas(*inputs, bs, 5)
    zero = lt == 0
    if zero.any():
        assert not got[zero].any(), what
    plain = ref.paged_attention_ref(qg, kpt, vpt, tt, lt)
    np.testing.assert_allclose(got[~zero].numpy(), plain[~zero].numpy(),
                               **TOL)


@pytest.mark.parametrize("bs,qpk,hd", [
    (bs, qpk, (64, 80, 128, 256)[(i + j) % 4])
    for i, bs in enumerate((1, 10, 16, 32))
    for j, qpk in enumerate((1, 2, 4, 7))
])
def test_split_ref_over_pages_heads_and_dims(bs, qpk, hd):
    """Pages of 1, 10, 16 and 32 tokens, qpk 1, 2, 4 and 7, each head dim
    of 64, 80, 128 and 256 at every page size and every qpk: ragged rows
    with stale lengths (a free slot's last length, its table's pages
    shuffled over the pool), lengths 0 and 1 among them, at the planner's
    split of a small batch and at 3 blocks."""
    nkv, max_pages = 2, max(2, 96 // bs)
    t = max_pages * bs
    lengths = [0, 1, bs, bs + 1, t // 2 + 3, t]
    b = len(lengths)
    inputs = _split_inputs(2 + bs + qpk, b, nkv * qpk, nkv, hd, bs,
                           b * max_pages, max_pages, lengths)
    n_plan = split_plan(b * nkv, max_pages, bs)
    for n_split in sorted({n_plan, 3}):
        qg, kpt, vpt, tt, lt, got = _split_vs_pallas(*inputs, bs, n_split)
        zero = lt == 0
        assert not got[zero].any()
        plain = ref.paged_attention_ref(qg, kpt, vpt, tt, lt)
        np.testing.assert_allclose(got[~zero].numpy(),
                                   plain[~zero].numpy(), **TOL)


@pytest.mark.parametrize("max_pages", [1, 2, 3, 4, 5, 7, 8, 20, 31, 32, 33,
                                       64, 100, 257, 2048])
def test_split_plan_covers_every_page_once(max_pages):
    """At granite's decode batch (64 groups) and 16-token pages: for every
    length up to the table's width, the plan's blocks walk whole pages (a
    tile each) in order, cover ``[0, length)`` once between them, and no
    block walks more than ``ceil(live tiles / n_split)`` of them."""
    n_split = split_plan(64, max_pages)
    assert 1 <= n_split <= MAX_SPLIT
    width = max_pages * 16
    for length in sorted({*range(0, width + 1, max(1, width // 600)),
                          width}):
        blocks = split_tiles(length, n_split)
        assert len(blocks) == n_split
        covered = sorted(t for tiles in blocks for t0, t1 in tiles
                         for t in range(t0, t1))
        assert covered == list(range(length))
        live = -(-length // 16)
        for tiles in blocks:
            assert len(tiles) <= -(-live // n_split)
            for t0, t1 in tiles:
                assert t0 % 16 == 0 and t0 < t1 <= min(t0 + 16, length)


@pytest.mark.parametrize("max_pages,bs,plan", [
    (32, 16, 8),     # cache 512 in 16-token pages: 4 pages a block
    (6, 16, 2),      # cache 96: two blocks
    (4, 16, 1),      # cache 64: one block
    (10, 10, 2),     # cache 100 in 10-token pages: 100 tokens, two
    (97, 1, 2),      # cache 97 in 1-token pages: two blocks
    (100, 10, 8),    # cache 1000: 8 blocks
    (256, 1, 4),     # 64 one-token pages a block, as 4 pages of 16
])
def test_split_plan_counts_tokens(max_pages, bs, plan):
    """At one slot of 8 kv heads (8 groups: up to 33 blocks a group fill
    the card) the table's width bounds the split: blocks cover at least
    ``MIN_TOKENS_PER_SPLIT`` tokens of it whatever the page size, so that
    a cache viewed in smaller pages splits as the same tokens in 16-token
    pages do; that is a 16-token tile for each of a block's four warps."""
    assert split_plan(8, max_pages, bs) == plan
    assert MIN_TOKENS_PER_SPLIT == 4 * 16


def test_split_plan_at_granite_decode():
    """cache_len 512 in 16-token pages: 4 blocks per (slot, kv head), 8 x 8
    x 4 = 256 blocks at max_batch 8, two on each SM."""
    cfg = get_config("granite-3-2b")
    groups = 8 * cfg.n_kv_heads
    assert split_plan(groups, 512 // transformer.DECODE_PAGE) == 4
    assert groups * split_plan(groups, 32) == 256


@pytest.mark.parametrize("b,n_kv,qpk,cache,plan", [
    (256, 8, 4, 1024, 1),   # the closed cell: 2,048 blocks
    (64, 8, 4, 2048, 1),    # the open cell: 512 blocks
    (8, 32, 1, 512, 1),     # llama2-7b's decode at B 8: 256 groups
    (4, 32, 1, 1024, 2),    # zamba2-2.7b's at B 4: 128 groups
    (4, 8, 4, 512, 8),      # h2o-danube-1.8b's at B 4: 32 groups
    (2, 8, 7, 3136, 8),     # llava-next-34b: 16 groups of 8 heads
])
def test_split_plan_at_the_cells(b, n_kv, qpk, cache, plan):
    """Wide batches fill the card unsplit; small ones split while
    ``BLOCKS_PER_SM`` blocks on each of 132 SMs hold them, up to a full
    cluster."""
    groups = b * n_kv * -(-qpk // heads_per_block(qpk))
    assert split_plan(groups, cache // 16) == plan


@pytest.mark.parametrize("qpk,bf16,heads", [
    (1, True, 1), (2, True, 2), (3, True, 3), (4, True, 4), (5, True, 5),
    (7, True, 7), (9, True, 8), (1, False, 1), (2, False, 2),
    (3, False, 4), (7, False, 4),
])
def test_heads_per_block(qpk, bf16, heads):
    """The bf16 kernel's mma serves up to 8 q heads a block (llava's qpk 7
    in one block, starcoder2's 9 in two); the float32 kernel up to 4, in
    powers of two."""
    assert heads_per_block(qpk, bf16) == heads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 128, 256])
@pytest.mark.parametrize("s", [64, 100, 128, 448, 512])
def test_flash_path_rule(dtype, hd, s):
    want = ("tensor_core" if dtype == torch.bfloat16
            and hd in (32, 64, 80, 128) and s % 64 == 0 else "cuda_core")
    assert flash_path(dtype, hd, s) == want


@pytest.mark.parametrize("qpk,hd,heads", [
    (4, 64, 4), (4, 32, 4), (4, 128, 2), (2, 64, 2), (1, 64, 1), (3, 64, 1),
    (8, 128, 2), (1, 128, 1),
    # hd 80: 2 warpgroups at most (4 would spill), so h2o-danube's qpk 4
    # runs two blocks a kv head
    (1, 80, 1), (2, 80, 2), (4, 80, 2), (8, 80, 2),
])
def test_tc_heads(qpk, hd, heads):
    assert tc_heads(qpk, hd) == heads


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("qpk", [1, 2, 4, 8])
def test_flash_smem_fits_a_block(hd, qpk):
    for path in ("tensor_core", "cuda_core"):
        assert 0 < flash_smem(hd, path=path, qpk=qpk) <= BLOCK_SMEM
    # the granite block: two buffers of 4 q tiles and four K/V stages, of
    # 8 KB tiles
    if (hd, qpk) == (64, 4):
        assert flash_smem(hd, path="tensor_core", qpk=qpk) == (
            1024 + 16 * 8192 + 96)
    # hd 80: tiles of an 8 KB 64-column block and a 2 KB 16-column block,
    # two buffers of 1 or 2 q tiles beside the four K/V stages
    if hd == 80:
        heads = {1: 1, 2: 2, 4: 2, 8: 2}[qpk]
        assert flash_smem(hd, path="tensor_core", qpk=qpk) == (
            1024 + 2 * (heads + 4) * 10_240 + 96)


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("qpk", [1, 2, 4, 8])
def test_paged_smem_fits_a_block(hd, qpk):
    """Both kernels' blocks fit; the bf16 ring keeps three blocks on an SM
    at the cells' hd 64 and 80 (228 KB an SM, 1 KB of it each block's)."""
    for bf16 in (True, False):
        assert 0 < paged_smem(qpk, hd, bf16) <= BLOCK_SMEM
    if hd in (64, 80):
        assert 3 * (paged_smem(qpk, hd) + 1024) <= 228 * 1024


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
    plan takes the page count by the rule of every cache length, and its
    blocks' tiles cover each slot's live tokens."""
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
    groups = b * cfg.n_kv_heads
    n_split = split_plan(groups, n_pages, bs)
    assert n_split == max(1, min(MAX_SPLIT, -(-t // MIN_TOKENS_PER_SPLIT),
                                 BLOCKS_PER_SM * H100_SMS // groups))
    for length in lengths.tolist():
        blocks = split_tiles(length, n_split)
        assert sorted(x for tiles in blocks for r in tiles
                      for x in range(*r)) == list(range(length))


def test_every_cache_len_views_as_whole_pages():
    for t in range(1, 600):
        bs = transformer.decode_page(t)
        assert t % bs == 0 and 1 <= bs <= transformer.DECODE_PAGE
        assert (bs == transformer.DECODE_PAGE) == (t % 16 == 0)
