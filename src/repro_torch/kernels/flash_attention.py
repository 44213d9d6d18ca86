"""Launcher of the CUDA causal / sliding-window GQA flash-attention kernel
(``csrc/flash_attention.cu``), the prefill path.

The CUDA counterpart of the JAX package's Pallas ``flash_attention``.  This
module only checks the arguments and launches; ``ops.flash_prefill`` is the
public wrapper, which scales q, keeps the block-size contract, takes the
plain version for CPU tensors and counts launches.

Layouts (as the Pallas kernel's): q (B, nh, S, hd) pre-scaled, k/v
(B, n_kv, S, hd), kv head = q head // qpk.  The tensors may be transposed
views: the kernel takes strides for the batch, head and sequence axes and
needs only hd contiguous.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.paged_attention import check_float_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SYMBOL = "flash_attention_launch"
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def flash_attention(fn, q, k, v, *, window: int = 0):
    """Launch the kernel through ``fn`` (the loaded C entry point) on CUDA
    tensors; returns the (B, nh, S, hd) output as a transposed view of a
    contiguous (B, S, nh, hd) buffer."""
    b, nh, s, hd = q.shape
    n_kv = k.shape[1]
    is_bf16 = check_float_inputs("flash_attention", hd, q, k, v)
    if k.shape != v.shape or k.shape != (b, n_kv, s, hd) or nh % n_kv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)) or k.stride() != v.stride():
        raise ValueError("flash_attention: head_dim must be contiguous and "
                         "k/v must share strides")
    out = torch.empty((b, s, nh, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = torch.tensor(
        [t.stride(i) for t in (q, k, out) for i in (0, 1, 2)],
        dtype=torch.int64,
    )
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, nh, s, nh // n_kv, hd, int(window), strides.data_ptr(),
             is_bf16, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
