"""Launcher of the CUDA chunkwise-mLSTM kernel (``csrc/mlstm_chunk.cu``),
the prefill path of the xLSTM family.

The CUDA counterpart of the JAX package's Pallas ``mlstm_chunk_kernel``,
with recurrent state in and out and any sequence length.  This module only
checks the arguments and launches; ``ops.mlstm_chunk`` is the public
wrapper, which takes the plain version for CPU tensors and counts launches.

Layouts: q, k, v (B, H, S, hd) in float32 or bfloat16, possibly transposed
views of (B, S, H, hd) tensors (hd contiguous); i_raw, log_f (B, H, S)
float32; state C (B, H, hd, hd), n (B, H, hd), m (B, H) float32.  The output
h is (B, H, S, hd) in q's type, a transposed view of a contiguous
(B, S, H, hd) buffer.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.paged_attention import check_float_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_chunk.cu"
SYMBOL = "mlstm_chunk_launch"
ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
#: the largest chunk the kernel's shared-memory tiles hold
MAX_CHUNK = 64


def tile_cols(hd: int) -> int:
    """Columns of C one block owns (``tv`` of ``launch`` in the source)."""
    return 64 if hd % 64 == 0 else 32 if hd % 32 == 0 else 16


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one block, as ``launch`` in the source
    sizes it: the hd x 64 slice of C, the q, k and gate-weight tiles of
    64 x 65, the v tile of 64 x 64, n, and eight vectors of 64."""
    c, pad = MAX_CHUNK, MAX_CHUNK + 1
    return 4 * (hd * 64 + 3 * c * pad + c * 64 + hd + 8 * c)


def _check_f32(name: str, t, shape, device) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"mlstm_chunk: {name} must be a contiguous float32 "
                         f"{shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def mlstm_chunk(fn, q, k, v, i_raw, log_f, state=None, *,
                chunk: int = MAX_CHUNK):
    """Launch the kernel through ``fn`` (the loaded C entry point) on CUDA
    tensors; returns ``(h, (C, n, m))``."""
    b, h, s, hd = q.shape
    is_bf16 = check_float_inputs("mlstm_chunk", hd, q, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunk: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must match q {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("mlstm_chunk: head_dim must be contiguous")
    dev = q.device
    for name, t in (("i_raw", i_raw), ("log_f", log_f)):
        _check_f32(name, t, (b, h, s), dev)
    shapes = ((b, h, hd, hd), (b, h, hd), (b, h))
    if state is not None:
        for name, t, shape in zip(("C", "n", "m"), state, shapes):
            _check_f32(name, t, shape, dev)
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    new = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                for shape in shapes)
    strides = torch.tensor(
        [t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)],
        dtype=torch.int64,
    )
    c_in, n_in, m_in = ((t.data_ptr() for t in state) if state is not None
                        else (None, None, None))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(),
             log_f.data_ptr(), c_in, n_in, m_in, out.data_ptr(),
             *(t.data_ptr() for t in new), b, h, s, hd, chunk,
             strides.data_ptr(), is_bf16,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mlstm_chunk launch failed: CUDA error {err}")
    return out, new
