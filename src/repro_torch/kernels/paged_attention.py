"""Launcher of the CUDA paged GQA decode kernel (``csrc/paged_attention.cu``).

The CUDA counterpart of the JAX package's Pallas ``paged_attention``: one
query token per sequence attends to its KV pages with an online softmax.
Each (sequence, kv head, group of q heads) runs on ``n_split`` blocks of
one cluster (``split_plan``, from the shapes alone), which merge their
partial softmax states in the same launch.  In bf16 the blocks share the
live tokens only, in 16-token tiles dealt in turn (``split_tiles``);
float32 splits the table's width.  This module only checks the
arguments, plans the split and launches; ``ops.paged_gqa_decode`` is the
public wrapper, which takes the plain version for CPU tensors and counts
launches.

Layouts (as the Pallas kernel's):

  q:            (B, n_kv, qpk, hd)   not pre-scaled: the kernel applies
                                     ``scale``
  k_pages:      (n_pages, block_size, n_kv, hd)
  v_pages:      (n_pages, block_size, n_kv, hd)
  block_tables: (B, max_pages) int32 (entries clamped into the pool)
  lengths:      (B,) int32
  out:          (B, n_kv, qpk, hd)
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
SYMBOL = "paged_attention_launch"
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int])
#: blocks of one cluster at most (the portable cluster size)
MAX_SPLIT = 8
#: tokens of the table's width a block covers at least, before the walk is
#: split further: a 16-token tile for each of its four warps.  Counted in
#: tokens, so that a table of smaller pages splits as the same work in
#: 16-token pages would.
MIN_TOKENS_PER_SPLIT = 64
#: blocks an SM the split fills at most: a walk is split only while the
#: blocks fit this many on each SM (forced splits of 1 to 8 measured best
#: at about two blocks an SM at every phase-3 shape on an H100; PERF.md)
BLOCKS_PER_SM = 2
#: SMs of an H100 SXM, the planner's default
H100_SMS = 132
#: q heads one block serves at most (more are split over blocks): the bf16
#: kernel's mma has 8 columns, the float32 kernel keeps 4 heads' partials
MAX_HEADS = {True: 8, False: 4}
#: threads of a block (four warps in both kernels)
THREADS = 128
#: the bf16 kernel: tiles in each warp's ring, tokens a tile
STAGES = 2
TILE = 16


def split_plan(groups: int, max_pages: int, block_size: int = 16,
               n_sm: int = H100_SMS) -> int:
    """``n_split``: the blocks of one cluster that share the walk of each
    of ``groups`` (sequence, kv head, head group) triples, from shapes
    alone (never the lengths on the device, so the wrapper never
    synchronises): as many as ``BLOCKS_PER_SM`` blocks on each of ``n_sm``
    SMs hold, each covering at least ``MIN_TOKENS_PER_SPLIT`` tokens of the
    table's width, at least 1 and at most ``MAX_SPLIT``.  A wide batch
    does not split; a small one with long tables splits to a full
    cluster."""
    if groups < 1 or max_pages < 1 or block_size < 1 or n_sm < 1:
        raise ValueError(f"groups {groups}, max_pages {max_pages}, "
                         f"block_size {block_size} and n_sm {n_sm} must be "
                         "at least 1")
    by_width = -(-max_pages * block_size // MIN_TOKENS_PER_SPLIT)
    by_fill = BLOCKS_PER_SM * n_sm // groups
    return max(1, min(MAX_SPLIT, by_width, by_fill))


def split_tiles(length: int, n_split: int) -> list[list[tuple[int, int]]]:
    """The token ranges ``[t0, t1)`` each of the ``n_split`` blocks of the
    bf16 kernel walks for a sequence of ``length`` live tokens: the
    ``TILE``-token tiles below the length, tile g to block g % n_split,
    the last one clipped at the length."""
    return [[(t, min(t + TILE, length))
             for t in range(r * TILE, length, n_split * TILE)]
            for r in range(n_split)]


def heads_per_block(qpk: int, bf16: bool = True) -> int:
    """q heads of one block: bf16 up to ``MAX_HEADS[True]`` (the mma's
    columns, whatever qpk), float32 the next power of two at or above qpk,
    at most ``MAX_HEADS[False]``."""
    if bf16:
        return min(qpk, MAX_HEADS[True])
    qt = 1
    while qt < min(qpk, MAX_HEADS[False]):
        qt *= 2
    return qt


def smem_bytes(qpk: int, hd: int, bf16: bool = True) -> int:
    """Dynamic shared memory of one block, as the source sizes it.  bf16:
    each warp's ring of ``STAGES`` tiles of ``TILE`` K and V rows (hd
    elements and 16 bytes of padding each) and its p tile (8 heads of 24
    floats), and the block's merged partial for 8 heads (f32).  float32:
    each warp's partial and the block's merged one (hd accumulators, m and
    l) for ``heads_per_block(qpk, False)`` heads."""
    warps = THREADS // 32
    if not bf16:
        return 4 * (warps + 1) * heads_per_block(qpk, False) * (hd + 2)
    heads = MAX_HEADS[True]
    return (warps * STAGES * 2 * TILE * (2 * hd + 16)
            + 4 * warps * heads * 24 + 4 * heads * (hd + 2))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_float_inputs(name: str, hd: int, *tensors) -> int:
    """Shared argument checks of the attention kernels; returns is_bf16."""
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} is not float32 or bfloat16")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"{name}: head_dim {hd} is not a multiple of 16 "
                         f"in [16, 256]")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {t.device}")
        # the kernels load 16 bytes at a time from each row
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must start on 16-byte "
                             "boundaries")
    return int(dtype == torch.bfloat16)


def paged_attention(fn, q, k_pages, v_pages, block_tables, lengths, *,
                    block_size: int = 16, scale: float = 1.0):
    """Launch the kernel through ``fn`` (the loaded C entry point) on CUDA
    tensors; returns the (B, n_kv, qpk, hd) output."""
    b, n_kv, qpk, hd = q.shape
    n_pages, bs = k_pages.shape[0], k_pages.shape[1]
    is_bf16 = check_float_inputs("paged_attention", hd, q, k_pages, v_pages)
    if bs != block_size:
        raise ValueError(f"paged_attention: pages hold {bs} tokens, "
                         f"block_size is {block_size}")
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (n_kv, hd):
        raise ValueError(f"paged_attention: page shape {tuple(k_pages.shape)}"
                         f" does not match q {tuple(q.shape)}")
    for t in (q, k_pages, v_pages, block_tables, lengths):
        if not t.is_contiguous():
            raise ValueError("paged_attention: inputs must be contiguous")
    for t, shape in ((block_tables, (b, block_tables.shape[1])),
                     (lengths, (b,))):
        if t.dtype != torch.int32 or t.device != q.device or t.shape != shape:
            raise ValueError("paged_attention: block_tables (B, max_pages) "
                             "and lengths (B,) must be int32 on q's device")
    max_pages = block_tables.shape[1]
    groups = b * n_kv * -(-qpk // heads_per_block(qpk, bool(is_bf16)))
    n_split = split_plan(groups, max_pages, bs, sm_count(q.device.index))
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, n_kv, qpk, hd, n_pages, bs, max_pages, is_bf16,
             torch.cuda.current_stream(q.device).cuda_stream, float(scale),
             n_split)
    if err:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
