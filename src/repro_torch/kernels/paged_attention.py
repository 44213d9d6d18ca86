"""Launcher of the CUDA paged GQA decode kernel (``csrc/paged_attention.cu``).

The CUDA counterpart of the JAX package's Pallas ``paged_attention``: one
query token per sequence attends to its KV pages, walked in block-table
order with an online softmax.  This module only checks the arguments and
launches; ``ops.paged_gqa_decode`` is the public wrapper, which scales q,
takes the plain version for CPU tensors and counts launches.

Layouts (as the Pallas kernel's):

  q:            (B, n_kv, qpk, hd)   pre-scaled by hd**-0.5
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
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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
                    block_size: int = 16):
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
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, n_kv, qpk, hd, n_pages, bs, block_tables.shape[1], is_bf16,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
