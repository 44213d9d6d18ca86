"""Launcher of the CUDA chunkwise-mLSTM kernel (``csrc/mlstm_chunk.cu``),
the prefill path of the xLSTM family.

The CUDA counterpart of the JAX package's Pallas ``mlstm_chunk_kernel``,
with recurrent state in and out and any sequence length.  This module
checks the arguments, picks the kernel's instantiation and launches;
``ops.mlstm_chunk`` is the public wrapper, which takes the plain version
for CPU tensors and counts launches.

Layouts: q, k, v (B, H, S, hd) in float32 or bfloat16, possibly transposed
views of (B, S, H, hd) tensors (hd contiguous); i_raw, log_f (B, H, S)
float32, any strides (the model's are views of (B, S, H) gates, which the
kernels read in place); state C (B, H, hd, hd), n (B, H, hd), m (B, H)
float32.  The output h is (B, H, S, hd) in q's type, a transposed view of a
contiguous (B, S, H, hd) buffer.

Which instantiation runs is a rule on the arguments, ``mlstm_path``: bf16
with hd a multiple of 64 and 64-token chunks takes the tensor-core kernel,
two launches (a states pass that walks the chunks and hands each chunk's
starting state to a scratch, and an outputs pass over every chunk at
once; ``ref.mlstm_chunk_twopass_ref`` is its plain version); everything
else, float32 included, the CUDA-core kernel.  A launch that fails raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.paged_attention import check_float_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_chunk.cu"
SYMBOL = "mlstm_chunk_launch"
ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
#: the largest chunk the kernels' tiles hold
MAX_CHUNK = 64
#: the tensor-core kernel's chunk, and the rows and columns of its tiles
TC_CHUNK = 64
#: depth of the states pass's K/V ring
TC_STAGES = 6
#: threads of a block of each tensor-core pass, as the source sizes them
THREADS = {"states": 288, "outputs": 128}
PATHS = ("tensor_core", "cuda_core")


def mlstm_path(dtype, hd: int, chunk: int) -> str:
    """``"tensor_core"`` for bf16 with hd a multiple of 64 and 64-token
    chunks (what ``ssm.MLSTM_CHUNK`` passes), else ``"cuda_core"``
    (float32 stays off the tensor cores: the 2e-5 parity of the float32
    engines)."""
    if dtype == torch.bfloat16 and hd % 64 == 0 and chunk == TC_CHUNK:
        return "tensor_core"
    return "cuda_core"


def tile_cols(hd: int) -> int:
    """Columns of C one CUDA-core block owns (``tv`` of ``launch`` in the
    source)."""
    return 64 if hd % 64 == 0 else 32 if hd % 32 == 0 else 16


def smem_bytes(hd: int, *, kernel: str = "cuda_core") -> int:
    """Dynamic shared memory of one block, as the source sizes it.

    ``cuda_core``: the hd x 64 slice of C, the q, k and gate-weight tiles of
    64 x 65, the v tile of 64 x 64, n, and eight vectors of 64, f32.
    ``states``: 1 KB of alignment slack, ``TC_STAGES`` bf16 (k, v, w v's lo
    part) tile triples with each chunk's 64 gate weights and 4 scalars, two
    chunks' bf16 tiles staging C (hi and lo) for the scratch, and per stage
    a loaded, a ready and a free mbarrier.
    ``outputs``: 1 KB of slack, hd / 64 bf16 tiles each of q, k and the
    chunk's starting C's hi and lo parts, one v tile, F and i of the chunk,
    n, m (padded to 4 floats) and two mbarriers.
    """
    tile = TC_CHUNK * TC_CHUNK * 2
    if kernel == "states":
        return (1024 + TC_STAGES * (3 * tile + 4 * (TC_CHUNK + 4))
                + 4 * tile + 24 * TC_STAGES)
    if kernel == "outputs":
        return (1024 + (4 * (hd // 64) + 1) * tile
                + 4 * (2 * TC_CHUNK + hd + 4) + 16)
    c, pad = MAX_CHUNK, MAX_CHUNK + 1
    return 4 * (hd * 64 + 3 * c * pad + c * 64 + hd + 8 * c)


def grids(b: int, h: int, s: int, hd: int, path: str) -> dict:
    """Blocks of each launch, as the source sizes the grids."""
    if path == "tensor_core":
        tiles = hd // TC_CHUNK
        return {"states": tiles * tiles * b * h,
                "outputs": tiles * -(-s // TC_CHUNK) * b * h}
    return {"cuda_core": hd // tile_cols(hd) * b * h}


def _check_f32(name: str, t, shape, device, *, contiguous=True) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or t.device != device or (contiguous and not t.is_contiguous())):
        kind = "contiguous float32" if contiguous else "float32"
        raise ValueError(f"mlstm_chunk: {name} must be a {kind} {shape} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def mlstm_chunk(fn, q, k, v, i_raw, log_f, state=None, *,
                chunk: int = MAX_CHUNK, path: str | None = None):
    """Launch the kernel through ``fn`` (the loaded C entry point) on CUDA
    tensors; returns ``(h, (C, n, m))``.

    ``path`` overrides ``mlstm_path`` (a check may run the CUDA-core kernel
    on what the rule sends to the tensor cores; the tensor-core kernel
    takes only what the rule gives it).
    """
    b, h, s, hd = q.shape
    rule = mlstm_path(q.dtype, hd, chunk)
    path = path or rule
    if path not in PATHS or (path == "tensor_core" and rule != path):
        raise ValueError(f"mlstm_chunk: path {path!r} does not take "
                         f"{q.dtype} at hd {hd}, chunk {chunk}")
    tc = path == "tensor_core"
    is_bf16 = check_float_inputs("mlstm_chunk", hd, q, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunk: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must match q {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("mlstm_chunk: head_dim must be contiguous")
    dev = q.device
    for name, t in (("i_raw", i_raw), ("log_f", log_f)):
        _check_f32(name, t, (b, h, s), dev, contiguous=False)
    shapes = ((b, h, hd, hd), (b, h, hd), (b, h))
    if state is not None:
        for name, t, shape in zip(("C", "n", "m"), state, shapes):
            _check_f32(name, t, shape, dev)
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    new = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                for shape in shapes)
    # each chunk's starting (C, n, m), written by the states pass for the
    # outputs pass; C as two bf16 parts, hi and lo: 4 hd^2 bytes per
    # (sequence, head, chunk), 8.4 MB at xlstm-350m's prefill of 512 tokens,
    # growing linearly with S
    nc = -(-s // TC_CHUNK)
    scratch = ((torch.empty((b, h, nc, 2, hd, hd), dtype=torch.bfloat16,
                            device=dev),
                torch.empty((b, h, nc, hd), dtype=torch.float32, device=dev),
                torch.empty((b, h, nc), dtype=torch.float32, device=dev))
               if tc else None)
    strides = (ctypes.c_int64 * 18)(
        *(t.stride(i) for t in (q, k, v, out, i_raw, log_f)
          for i in (0, 1, 2)))
    c_in, n_in, m_in = ((t.data_ptr() for t in state) if state is not None
                        else (None, None, None))
    c_ch, n_ch, m_ch = ((t.data_ptr() for t in scratch) if tc
                        else (None, None, None))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(),
             log_f.data_ptr(), c_in, n_in, m_in, out.data_ptr(),
             *(t.data_ptr() for t in new), c_ch, n_ch, m_ch, b, h, s, hd,
             chunk, ctypes.addressof(strides), is_bf16,
             torch.cuda.current_stream(dev).cuda_stream, int(tc))
    if err:
        raise RuntimeError(f"mlstm_chunk launch failed: CUDA error {err}")
    return out, new
