"""Public wrappers around the CUDA kernels, and their build.

Each wrapper takes its plain PyTorch version (``ref.py``) for tensors on the
CPU, and only then.  For CUDA tensors it launches its kernel or raises;
there is no fallback.  Each wrapper counts its launches in a plain integer
attribute (``paged_gqa_decode.launches``, ``flash_prefill.launches``,
``mlstm_chunk.launches``), so a run can show that its main path went
through the kernels.

The kernels are built at first use: every ``csrc/*.cu`` source is compiled
by its own ``nvcc`` process (all started together) into a shared library
with a plain C interface under ``build/torch_kernels/`` at the repository
root, named by the hash of its sources, and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mlstm_chunk as _mlstm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels.ref import (
    flash_attention_ref,
    mlstm_chunk_ref,
    paged_attention_ref,
)

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
_KERNELS = {"paged_attention": _paged, "flash_attention": _flash,
            "mlstm_chunk": _mlstm}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(src: Path) -> Path:
    h = hashlib.sha1()
    for path in sorted(src.parent.glob("*.cuh")) + [src]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


@functools.cache
def kernel_library() -> dict:
    """Build (where not yet built) and load every kernel; returns the C
    entry points by kernel name.  Compiler output, with the register and
    shared-memory use ``-Xptxas=-v`` prints, lands beside each library as
    ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _library_path(mod.SOURCE)
               for name, mod in _KERNELS.items()}
    procs = {}
    for name, lib in targets.items():
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(_KERNELS[name].SOURCE)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    fns = {}
    for name, lib in targets.items():
        fn = getattr(ctypes.CDLL(str(lib)), _KERNELS[name].SYMBOL)
        fn.argtypes = _KERNELS[name].ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def paged_gqa_decode(
    q,              # (B, nh, hd) one query token per sequence
    k_pages,        # (P, block_size, n_kv, hd)
    v_pages,
    block_tables,   # (B, max_pages) int32
    lengths,        # (B,) int32
    *,
    block_size: int = 16,
):
    """Paged decode attention; returns (B, nh, hd).  The kernel applies
    the hd^-0.5 scale itself; the plain version takes q pre-scaled."""
    b, nh, hd = q.shape
    n_kv = k_pages.shape[2]
    qg = q.reshape(b, n_kv, nh // n_kv, hd)
    if q.device.type == "cpu":
        out = paged_attention_ref(qg * hd ** -0.5, k_pages, v_pages,
                                  block_tables, lengths)
    else:
        out = _paged.paged_attention(
            kernel_library()["paged_attention"], qg, k_pages, v_pages,
            block_tables, lengths, block_size=block_size, scale=hd ** -0.5,
        )
        paged_gqa_decode.launches += 1
    return out.reshape(b, nh, hd)


paged_gqa_decode.launches = 0


def flash_prefill(
    q,   # (B, S, nh, hd)
    k,   # (B, S, n_kv, hd)
    v,
    *,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
):
    """Causal (optionally SWA) prefill attention; returns (B, S, nh, hd).

    Keeps the Pallas kernel's contract: S must be divisible by both block
    sizes, else ``ValueError``.  The kernel applies the hd^-0.5 scale to
    its f32 scores; the plain version takes q pre-scaled.
    """
    s, hd = q.shape[1], q.shape[-1]
    if s % block_q or s % block_k:
        raise ValueError(f"S={s} must be divisible by block sizes")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        out = flash_attention_ref(qt * hd ** -0.5, kt, vt, window=window)
    else:
        out = _flash.flash_attention(
            kernel_library()["flash_attention"], qt, kt, vt, window=window,
            scale=hd ** -0.5,
        )
        flash_prefill.launches += 1
    return out.transpose(1, 2)


flash_prefill.launches = 0


def mlstm_chunk(
    q,        # (B, H, S, hd)
    k,
    v,
    i_raw,    # (B, H, S)
    log_f,    # (B, H, S)
    state=None,   # (C (B,H,hd,hd), n (B,H,hd), m (B,H)) float32, or None
    *,
    chunk: int = _mlstm.MAX_CHUNK,
):
    """Chunkwise-parallel mLSTM from ``state`` (None: the empty state);
    returns ``(h (B,H,S,hd) in q's dtype, (C, n, m))``.

    Any S: unlike the Pallas kernel's contract, a chunk that does not
    divide S is not refused; the last chunk is masked (see ``ref.py``).
    ``chunk`` is at most the kernel's tile, ``MAX_CHUNK`` tokens, on every
    device.  On the card the launcher picks the instantiation by
    ``mlstm_chunk.mlstm_path``: bf16 at hd 64..256 in 64-token chunks runs
    the two tensor-core passes (one launch counted), all else the CUDA-core
    kernel.
    """
    if not 1 <= chunk <= _mlstm.MAX_CHUNK:
        raise ValueError(f"mlstm_chunk: chunk {chunk} is not in "
                         f"[1, {_mlstm.MAX_CHUNK}]")
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, i_raw, log_f, state, chunk=chunk)
    out = _mlstm.mlstm_chunk(
        kernel_library()["mlstm_chunk"], q, k, v, i_raw.float(),
        log_f.float(), state, chunk=chunk,
    )
    mlstm_chunk.launches += 1
    return out


mlstm_chunk.launches = 0


def reset_launch_counts() -> None:
    paged_gqa_decode.launches = 0
    flash_prefill.launches = 0
    mlstm_chunk.launches = 0
