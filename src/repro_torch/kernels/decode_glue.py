"""Launchers of the dense decode block's glue kernels
(``csrc/decode_glue.cu``): RMSNorm (alone, or after the residual add),
RoPE with the step's K/V and ``kv_pos`` writes, and SiLU-and-multiply.

They replace no Pallas kernel: the JAX package leaves this glue to XLA's
fusion under ``jit``, where the port's eager decode issued it as ~78
small kernels a layer.  This module checks the arguments and launches;
the public wrappers in ``ops.py`` (``fused_rms_norm``,
``fused_add_rms_norm``, ``rope_kv_write``, ``silu_mul``) take the plain
versions of ``ref.py`` for CPU tensors and count launches.  Every check
runs before the C entry point is reached.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_glue.cu"
#: the source's C entry points: name -> (symbol, argtypes)
ENTRIES = {
    "rms_norm": ("rms_norm_launch",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                 + [ctypes.c_float] + [ctypes.c_int] * 3
                 + [ctypes.c_void_p]),
    "rope_kv_write": ("rope_kv_write_launch",
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p]),
    "silu_mul": ("silu_mul_launch",
                 [ctypes.c_void_p] * 3
                 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]),
}


def reduce_lanes(d: int, rows: int) -> tuple[int, int]:
    """How PyTorch's CUDA reduction reads ``torch.mean(y, dim=-1)`` of a
    contiguous float32 (rows, d), as ATen's ``setReduceConfig`` chooses
    it: the lanes it gives a row (a power of two up to 512) and whether
    they read groups of four (its vectorised input, for d >= 128).  The
    norm kernel adds its squares in that order.  Where PyTorch would also
    split a row over warps (d/lanes at least min(16 rows a block, 256):
    d >= 8192 at these widths) the kernel keeps the one-warp order, and
    its variance may differ from PyTorch's in the last bit."""
    vec = d >= 128
    dim0 = d // 4 if vec else d
    dim0_pow2 = 1 << (dim0.bit_length() - 1) if dim0 < 512 else 512
    rows = max(rows, 1)
    dim1_pow2 = 1 << (rows.bit_length() - 1) if rows < 512 else 512
    width = min(dim0_pow2, 32)
    height = min(dim1_pow2, 512 // width)
    return min(dim0_pow2, 512 // height), int(vec)


def _check_inputs(name: str, *tensors, hd=None) -> int:
    """The checks every glue kernel shares, in this order: a float32 or
    bfloat16 dtype, one dtype for all, a head dim the attention kernels
    take (where ``hd`` is given), one CUDA device, contiguous.  Returns
    is_bf16."""
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} is not float32 or bfloat16")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
    if hd is not None and (hd % 16 or not 16 <= hd <= 256):
        raise ValueError(f"{name}: head_dim {hd} is not a multiple of 16 "
                         f"in [16, 256]")
    _check_device(name, tensors[0].device, *tensors)
    return int(dtype == torch.bfloat16)


def _check_device(name: str, device, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _stream(t) -> int:
    """The current stream of t's device, as the raw pointer the C entry
    points take (``torch.cuda.current_stream(...).cuda_stream`` builds a
    Stream object first, ~8 µs of host time on the decode path)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def rms_norm(fn, x, w, eps: float, residual=None):
    """``rms_norm(x)`` over the last dim, or with ``residual`` the pair
    ``(x + residual, rms_norm(x + residual))``; ``w`` float32 (d,)."""
    d = x.shape[-1]
    xs = (x,) if residual is None else (x, residual)
    is_bf16 = _check_inputs("rms_norm", *xs)
    if w.dtype != torch.float32 or w.shape != (d,):
        raise ValueError(f"rms_norm: the scale must be float32 ({d},), got "
                         f"{w.dtype} {tuple(w.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"rms_norm: residual {tuple(residual.shape)} is "
                         f"not x's {tuple(x.shape)}")
    _check_device("rms_norm", x.device, w)
    out = torch.empty_like(x)
    total = None if residual is None else torch.empty_like(x)
    rows = x.numel() // d
    err = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
             w.data_ptr(), None if total is None else total.data_ptr(),
             out.data_ptr(), rows, d, float(eps), *reduce_lanes(d, rows),
             is_bf16, _stream(x))
    if err:
        raise RuntimeError(f"rms_norm launch failed: CUDA error {err}")
    return out if total is None else (total, out)


def rope_kv_write(fn, q, k, v, cos, sin, pos, k_cache, v_cache, kv_pos):
    """Rotate one token's q (B, 1, nh, hd) and k (B, 1, n_kv, hd) by the
    step's ``cos``/``sin`` (B * hd/2 float32), write k and v (B, 1, n_kv,
    hd) into cache row ``clamp(pos, 0, T-1)`` of ``k_cache``/``v_cache``
    (B, T, n_kv, hd) and ``pos`` (B,) int32 into ``kv_pos`` (B, T) int32
    there; returns rotated q as a fresh (B, nh, hd)."""
    b, s, nh, hd = q.shape
    _, t, n_kv, _ = k_cache.shape
    is_bf16 = _check_inputs("rope_kv_write", q, k, v, k_cache, v_cache,
                            hd=hd)
    if s != 1 or nh % n_kv or k.shape != (b, 1, n_kv, hd) \
            or v.shape != k.shape or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != b:
        raise ValueError(
            f"rope_kv_write: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} and the caches {tuple(k_cache.shape)} are "
            "not one decode token's (B, 1, n, hd) against (B, T, n_kv, hd)")
    for tab in (cos, sin):
        if tab.dtype != torch.float32 or tab.numel() != b * hd // 2:
            raise ValueError("rope_kv_write: cos and sin must be float32 "
                             f"with B * hd/2 = {b * hd // 2} entries")
    for ints, shape in ((pos, (b,)), (kv_pos, (b, t))):
        if ints.dtype != torch.int32 or ints.shape != shape:
            raise ValueError("rope_kv_write: pos (B,) and kv_pos (B, T) "
                             "must be int32")
    _check_device("rope_kv_write", q.device, cos, sin, pos, kv_pos)
    out = torch.empty((b, nh, hd), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
             sin.data_ptr(), pos.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), kv_pos.data_ptr(), out.data_ptr(), b, nh,
             n_kv, hd, t, is_bf16, _stream(q))
    if err:
        raise RuntimeError(f"rope_kv_write launch failed: CUDA error {err}")
    return out


def silu_mul(fn, a, b):
    """``silu(a) * b``, elementwise, as a fresh tensor of a's shape."""
    is_bf16 = _check_inputs("silu_mul", a, b)
    if a.shape != b.shape:
        raise ValueError(f"silu_mul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    out = torch.empty_like(a)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), is_bf16,
             _stream(a))
    if err:
        raise RuntimeError(f"silu_mul launch failed: CUDA error {err}")
    return out
