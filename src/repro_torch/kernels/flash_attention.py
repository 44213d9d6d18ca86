"""Launcher of the CUDA causal / sliding-window GQA flash-attention kernel
(``csrc/flash_attention.cu``), the prefill path.

The CUDA counterpart of the JAX package's Pallas ``flash_attention``.  This
module checks the arguments, picks the kernel's instantiation and
launches; ``ops.flash_prefill`` is the public wrapper, which keeps the
block-size contract, takes the plain version for CPU tensors and counts
launches.

Layouts (as the Pallas kernel's): q (B, nh, S, hd), k/v (B, n_kv, S, hd),
kv head = q head // qpk.  q is not pre-scaled: the kernel multiplies the
scores by ``scale``.  The tensors may be transposed views: the kernel
takes strides for the batch, head and sequence axes and needs only hd
contiguous.

Which instantiation runs is a rule on the shape, ``flash_path``: bf16 at
hd 32, 64 or 128 with S a multiple of 64 takes the tensor-core kernel
(wgmma products, TMA copies); everything else, float32 included, the
CUDA-core kernel.  A launch that fails raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.paged_attention import check_float_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SYMBOL = "flash_attention_launch"
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_float, ctypes.c_int])
#: q rows of the tensor-core kernel's tile (and kv tokens of a K/V tile)
TC_ROWS = 64
#: head dims the tensor-core kernel is instantiated for
TC_HEAD_DIMS = (32, 64, 128)
#: depth of the tensor-core kernel's K/V ring
TC_STAGES = 4


def flash_path(dtype, hd: int, s: int) -> str:
    """``"tensor_core"`` for bf16 at hd 32, 64 or 128 with ``s`` a multiple
    of 64, else ``"cuda_core"`` (float32 stays off the tensor cores: TF32
    would break the 2e-5 parity of the float32 engines)."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and s % TC_ROWS == 0:
        return "tensor_core"
    return "cuda_core"


def tc_heads(qpk: int, hd: int) -> int:
    """q heads (one consumer warpgroup each) that a tensor-core block
    serves from one K/V stream: 4 where qpk allows it, 2 at hd 128 (a
    thread's output accumulator of hd / 2 floats would not fit the 128
    registers that 512 threads leave), else 1."""
    for heads in (4, 2):
        if qpk % heads == 0 and (heads < 4 or hd <= 64):
            return heads
    return 1


def smem_bytes(hd: int, *, path: str = "cuda_core", qpk: int = 1) -> int:
    """Dynamic shared memory of one block, as the source sizes it.

    cuda_core: the q tile and its accumulator, a K tile with padded rows,
    a V tile, the tile's probabilities and three vectors of the tile, f32.
    tensor_core: 1 KB of alignment slack, two buffers of one bf16 q tile
    per head of the block, ``TC_STAGES`` K/V tile pairs and the mbarriers
    (full and empty for each q buffer and each K/V stage).
    """
    if path == "tensor_core":
        tile = TC_ROWS * hd * 2
        return (1024 + 2 * (tc_heads(qpk, hd) + TC_STAGES) * tile
                + 8 * (4 + 2 * TC_STAGES))
    tile = 64 if hd <= 128 else 32
    return 4 * (2 * tile * hd + tile * (hd + 1) + tile * hd + tile * tile
                + 3 * tile)


def flash_attention(fn, q, k, v, *, window: int = 0, scale: float = 1.0):
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
    qpk = nh // n_kv
    heads = (tc_heads(qpk, hd)
             if flash_path(q.dtype, hd, s) == "tensor_core" else 0)
    out = torch.empty((b, s, nh, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 9)(
        *(t.stride(i) for t in (q, k, out) for i in (0, 1, 2)))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, nh, s, qpk, hd, int(window), ctypes.addressof(strides),
             is_bf16, torch.cuda.current_stream(q.device).cuda_stream,
             float(scale), heads)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
