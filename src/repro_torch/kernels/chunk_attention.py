"""Launcher of the CUDA chunked-prefill attention kernel
(``csrc/chunk_attention.cu``): a chunk of queries at an offset against a
slot cache, masked by the cache's ``kv_pos``.

It replaces no Pallas kernel: the JAX package computes chunked prefill's
attention as plain jnp (``attention_any``).  This module checks the
arguments and launches; ``ops.chunk_attention`` is the public wrapper,
which takes ``attention_any`` for CPU tensors and counts launches.

Layouts (as ``attention_any``'s): q (B, S, nh, hd), the cache k/v (B, T,
n_kv, hd), ``positions`` (B, S) the queries' positions, ``kv_pos`` (B, T)
int32 the cache rows' positions (negative: invalid); kv head = q head //
qpk.  q is not pre-scaled: the kernel multiplies its f32 scores by
``scale``.  The tensors may be views with any strides on the batch, head
and sequence axes; hd and ``kv_pos``'s rows must be contiguous.

The kernel is the tensor-core design only (``chunk_path``: bf16, hd 32,
64, 80 or 128, S a multiple of 64); the caller keeps ``attention_any``
for every other input.  It walks only the cache rows that its q tiles'
positions can attend, so it needs the slot cache's layout: positions
rising along each row, and a valid key at the row of its position
(``kv_pos[b, j]`` is j or negative), which the engine's chunked prefill
keeps.  A launch that fails raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.flash_attention import (
    TC_HEAD_DIMS,
    TC_ROWS,
    tc_heads,
)
from repro_torch.kernels.paged_attention import check_float_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "chunk_attention.cu"
SYMBOL = "chunk_attention_launch"
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_float])


def chunk_path(dtype, hd: int, s: int) -> bool:
    """Whether the kernel takes a chunk of ``s`` queries of head dim
    ``hd``: bf16 at hd 32, 64, 80 or 128 with ``s`` a multiple of 64, the
    tensor-core flash kernel's rule (``flash_path``)."""
    return dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and s % TC_ROWS == 0


def chunk_attention(fn, q, k_cache, v_cache, positions, kv_pos, *,
                    window: int = 0, scale: float = 1.0):
    """Launch the kernel through ``fn`` (the loaded C entry point) on CUDA
    tensors; returns the (B, S, nh, hd) output, contiguous."""
    b, s, nh, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"chunk_attention: dtype {q.dtype} is not bfloat16")
    if hd not in TC_HEAD_DIMS:
        raise ValueError(f"chunk_attention: head_dim {hd} is not one of "
                         f"{TC_HEAD_DIMS}")
    if s % TC_ROWS:
        raise ValueError(f"chunk_attention: a chunk of {s} queries is not a "
                         f"multiple of {TC_ROWS}")
    check_float_inputs("chunk_attention", hd, q, k_cache, v_cache)
    t, n_kv = k_cache.shape[1], k_cache.shape[2]
    if (v_cache.shape != k_cache.shape or k_cache.shape != (b, t, n_kv, hd)
            or nh % n_kv):
        raise ValueError(f"chunk_attention: k/v {tuple(k_cache.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if (any(x.stride(-1) != 1 for x in (q, k_cache, v_cache))
            or k_cache.stride() != v_cache.stride()):
        raise ValueError("chunk_attention: head_dim must be contiguous and "
                         "k/v must share strides")
    if positions.shape != (b, s) or kv_pos.shape != (b, t):
        raise ValueError(f"chunk_attention: positions {tuple(positions.shape)}"
                         f" and kv_pos {tuple(kv_pos.shape)} do not match "
                         f"q {tuple(q.shape)} and the cache's {t} rows")
    if kv_pos.dtype != torch.int32 or positions.is_floating_point():
        raise TypeError("chunk_attention: kv_pos must be int32 and "
                        "positions integers")
    for x in (positions, kv_pos):
        if x.device != q.device:
            raise ValueError(f"chunk_attention: every tensor must be on "
                             f"{q.device}, got {x.device}")
    # the kernel copies kv_pos through a 1-D tensor map over its whole
    # storage, which starts on a 16-byte boundary, each tile's entries in a
    # box from the boundary at or before them
    storage = kv_pos.untyped_storage()
    if (kv_pos.stride(1) != 1 or storage.data_ptr() % 16
            or storage.nbytes() // 4 >= 2 ** 31):
        raise ValueError("chunk_attention: kv_pos rows must be contiguous "
                         "in a storage on a 16-byte boundary of fewer than "
                         "2**31 entries")
    pos = positions.to(torch.int64)
    out = torch.empty((b, s, nh, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 13)(
        *(x.stride(i) for x in (q, k_cache, out) for i in (0, 2, 1)),
        pos.stride(0), pos.stride(1), kv_pos.storage_offset(),
        kv_pos.stride(0))
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             pos.data_ptr(), storage.data_ptr(), out.data_ptr(),
             b, nh, n_kv, s, t, hd, int(window), tc_heads(nh // n_kv, hd),
             ctypes.addressof(strides), storage.nbytes() // 4,
             torch.cuda.current_stream(q.device).cuda_stream, float(scale))
    if err:
        raise RuntimeError(f"chunk_attention launch failed: CUDA error {err}")
    return out
