"""Launcher of the CUDA paged GQA decode kernel (``csrc/paged_attention.cu``).

The CUDA counterpart of the JAX package's Pallas ``paged_attention``: one
query token per sequence attends to its KV pages with an online softmax.
The kernel splits each sequence's page walk over a cluster of blocks
(``split_plan``) and merges their partial softmax states in the same
launch.  This module only checks the arguments, plans the split and
launches; ``ops.paged_gqa_decode`` is the public wrapper, which takes the
plain version for CPU tensors and counts launches.

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
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
SYMBOL = "paged_attention_launch"
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int])
#: blocks of one cluster at most (the portable cluster size)
MAX_SPLIT = 8
#: tokens a block walks at least, before the walk is split further (8 pages
#: of 16 tokens measured faster than 4 at granite-3-2b's decode on an H100:
#: half the blocks and partials to merge for a second round of loads in
#: each block; PERF.md).  Counted in tokens, so that a table of smaller
#: pages splits as the same work in 16-token pages would.
MIN_TOKENS_PER_SPLIT = 128
#: q heads one block serves at most (more are split over clusters)
MAX_HEADS = 4
#: threads of a block
THREADS = 128


def split_plan(max_pages: int, block_size: int = 16) -> tuple[int, int]:
    """``(n_split, pages_per_split)``: the blocks of one cluster and the
    contiguous pages each walks, from the block table's width and page size
    alone (never from the lengths on the device, so the wrapper never
    synchronises).  Every page of ``max_pages`` is covered exactly once,
    ``n_split`` is at most ``MAX_SPLIT``, each block walks at least
    ``MIN_TOKENS_PER_SPLIT`` tokens where there are that many, and no
    block's range lies wholly past the table."""
    if max_pages < 1 or block_size < 1:
        raise ValueError(f"max_pages {max_pages} and block_size "
                         f"{block_size} must be at least 1")
    n_split = min(MAX_SPLIT,
                  -(-max_pages * block_size // MIN_TOKENS_PER_SPLIT))
    per = -(-max_pages // n_split)
    return -(-max_pages // per), per


def heads_per_block(qpk: int) -> int:
    """q heads of one block: the next power of two at or above qpk, at
    most ``MAX_HEADS``."""
    return 1 if qpk == 1 else 2 if qpk == 2 else MAX_HEADS


def smem_bytes(qpk: int, hd: int) -> int:
    """Dynamic shared memory of one block, as the source sizes it: each
    warp's partial and the block's merged one (hd accumulators, m and l,
    in f32), for ``heads_per_block(qpk)`` q heads."""
    return 4 * (THREADS // 32 + 1) * heads_per_block(qpk) * (hd + 2)


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
    n_split, per = split_plan(max_pages, bs)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, n_kv, qpk, hd, n_pages, bs, max_pages, is_bf16,
             torch.cuda.current_stream(q.device).cuda_stream, float(scale),
             n_split, per)
    if err:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
