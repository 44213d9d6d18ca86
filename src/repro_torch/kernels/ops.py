"""Public wrappers around the CUDA kernels, and their build.

Each wrapper takes its plain PyTorch version (``ref.py``) for tensors on the
CPU, and only then.  For CUDA tensors it launches its kernel or raises;
there is no fallback.  No kernel has a backward: the kernels write into
fresh buffers through ``ctypes``, so their outputs carry no ``grad_fn``,
and a CUDA call that would need one raises (``refuse_grad``).  The CPU
branch's plain versions stay differentiable.  Training runs the plain
attention and mLSTM by choice, as the JAX package trains on no Pallas
kernel.  Each wrapper counts its launches in an integer attribute
(``paged_gqa_decode.launches``, ``flash_prefill.launches``,
``chunk_attention.launches``, ``mlstm_chunk.launches``, and the decode
block's glue:
``fused_rms_norm``, ``fused_add_rms_norm``, ``rope_kv_write`` and
``silu_mul``), so a run can show that its main path went through the
kernels.  The counts are raised under a lock: a replicated
fleet advances its engines on several threads, and the ctypes calls
release the interpreter lock, so two engines really launch at once.

Under a sharded plan a wrapper given DTensors runs on their local shards
(``shardlib.local_call``) when each shard holds whole heads of whole
sequences (split on the batch or the heads only), and raises when the
head dim or the sequence is split: it never gathers quietly.  The callers
in ``models/transformer.py`` redistribute q, k and v to such a layout
first.

The kernels are built at first use: every ``csrc/*.cu`` source is compiled
by its own ``nvcc`` process (all started together) into a shared library
with a plain C interface under ``build/torch_kernels/`` at the repository
root, named by the hash of its sources, and loaded with ``ctypes``: one C
entry point a source (``SYMBOL``), or a dict of them where a source holds
several kernels (``ENTRIES``, the decode glue).  The
build and the load run once per process under a lock, whichever thread
asks first; the others wait for it and share its entry points.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import functools

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.kernels import chunk_attention as _chunk
from repro_torch.kernels import decode_glue as _glue
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mlstm_chunk as _mlstm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels.ref import (
    flash_attention_ref,
    mlstm_chunk_ref,
    paged_attention_ref,
    rms_norm_ref,
    rope_kv_write_ref,
    silu_mul_ref,
)

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
_KERNELS = {"paged_attention": _paged, "flash_attention": _flash,
            "chunk_attention": _chunk, "mlstm_chunk": _mlstm,
            "decode_glue": _glue}
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


_LIBRARY: dict = {}
_LIBRARY_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def kernel_library() -> dict:
    """Build (where not yet built) and load every kernel once per process;
    returns the C entry points by kernel name.  Compiler output, with the
    register and shared-memory use ``-Xptxas=-v`` prints, lands beside each
    library as ``<name>.log``."""
    with _LIBRARY_LOCK:
        if not _LIBRARY:
            _LIBRARY.update(_build_and_load())
        return _LIBRARY


def _build_and_load() -> dict:
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
        cdll, mod = ctypes.CDLL(str(lib)), _KERNELS[name]
        entries = getattr(mod, "ENTRIES", None)
        fns[name] = (
            _entry(cdll, mod.SYMBOL, mod.ARGTYPES) if entries is None
            else {key: _entry(cdll, *e) for key, e in entries.items()})
    return fns


def _entry(cdll, symbol: str, argtypes):
    fn = getattr(cdll, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and a floating input requires grad: the
    kernel behind ``name`` has no backward, and its output would silently
    cut the graph."""
    if torch.is_grad_enabled() and any(
            t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            "requires grad; call it under torch.no_grad(), or train on the "
            "plain version (layers.attention_any, ref.mlstm_chunk_ref)")


def _on_shards(name: str, wrapper, sig: str, *args, **kwargs):
    """``wrapper`` over the local shards of DTensor arguments whose dims
    named in ``sig`` are split only along ``b`` (batch) and ``n`` (heads);
    raises ``ValueError`` for any other split."""
    from repro_torch.models.shardlib import local_call

    labels = sig.split("->")[0].split(",")
    for lab, a in zip(labels, args):
        if not isinstance(a, DTensor):
            continue
        for p in a.placements:
            if isinstance(p, Shard) and lab[p.dim] not in "bn":
                raise ValueError(
                    f"{name}: an input is split along its dim {p.dim} "
                    f"({lab[p.dim]!r}); the kernel runs on shards holding "
                    "whole heads of whole sequences, so redistribute to a "
                    "heads-local layout first")
    return local_call(functools.partial(wrapper, **kwargs), sig, *args,
                      keep="bn", split="n")


def _any_dtensor(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def plain_cuda(*xs) -> bool:
    """Whether every tensor is a CUDA tensor and none a DTensor: the inputs
    that a kernel with no CPU branch of its own (the decode glue,
    ``chunk_attention``) is routed to by ``models/transformer.py``."""
    return all(x.device.type == "cuda" and not isinstance(x, DTensor)
               for x in xs)


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
    if _any_dtensor(q, k_pages, v_pages):
        return _on_shards("paged_gqa_decode", paged_gqa_decode,
                          "bnh,psnh,psnh,bq,b->bnh", q, k_pages, v_pages,
                          block_tables, lengths, block_size=block_size)
    b, nh, hd = q.shape
    n_kv = k_pages.shape[2]
    qg = q.reshape(b, n_kv, nh // n_kv, hd)
    if q.device.type == "cpu":
        out = paged_attention_ref(qg * hd ** -0.5, k_pages, v_pages,
                                  block_tables, lengths)
    else:
        refuse_grad("paged_gqa_decode", q, k_pages, v_pages)
        out = _paged.paged_attention(
            kernel_library()["paged_attention"], qg, k_pages, v_pages,
            block_tables, lengths, block_size=block_size, scale=hd ** -0.5,
        )
        _count(paged_gqa_decode)
    return out.reshape(b, nh, hd)


paged_gqa_decode.launches = 0


def flash_prefill(
    q,   # (B, S, nh, hd)
    k,   # (B, S, n_kv, hd)
    v,
    *,
    window: int = 0,
):
    """Causal (optionally SWA) prefill attention; returns (B, S, nh, hd).

    Keeps the Pallas kernel's contract at its blocks of
    ``PREFILL_BLOCK`` (64) tokens: S must be a multiple of 64, else
    ``ValueError``.  The kernel applies the hd^-0.5 scale to its f32
    scores; the plain version takes q pre-scaled.
    """
    if _any_dtensor(q, k, v):
        return _on_shards("flash_prefill", flash_prefill,
                          "bsnh,bsnh,bsnh->bsnh", q, k, v, window=window)
    s, hd = q.shape[1], q.shape[-1]
    if s % _flash.PREFILL_BLOCK:
        raise ValueError(f"S={s} must be a multiple of "
                         f"{_flash.PREFILL_BLOCK}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        out = flash_attention_ref(qt * hd ** -0.5, kt, vt, window=window)
    else:
        refuse_grad("flash_prefill", q, k, v)
        out = _flash.flash_attention(
            kernel_library()["flash_attention"], qt, kt, vt, window=window,
            scale=hd ** -0.5,
        )
        _count(flash_prefill)
    return out.transpose(1, 2)


flash_prefill.launches = 0


def chunk_attention(
    q,          # (B, S, nh, hd) a chunk of queries
    k_cache,    # (B, T, n_kv, hd)
    v_cache,
    positions,  # (B, S) the queries' positions
    kv_pos,     # (B, T) int32 the cache rows' positions, -1 = invalid
    *,
    window: int = 0,
):
    """Chunked prefill's attention: the queries against the whole cache,
    masked by ``kv_pos``; returns (B, S, nh, hd).  On the CPU it is
    ``attention_any(q, k_cache, v_cache, window=window,
    q_positions=positions, kv_positions=kv_pos, kv_valid=kv_pos >= 0)``,
    as ``dense_block_chunk`` calls it; on the card the kernel computes the
    same (hd^-0.5 applied to its f32 scores) for the inputs of
    ``chunk_attention.chunk_path`` over the slot cache's layout (see
    ``kernels/chunk_attention.py``), and refuses every other input."""
    if q.device.type == "cpu":
        # imported here: models.layers imports the models package, whose
        # transformer imports this module
        from repro_torch.models.layers import attention_any

        return attention_any(q, k_cache, v_cache, window=window,
                             q_positions=positions, kv_positions=kv_pos,
                             kv_valid=kv_pos >= 0)
    if _any_dtensor(q, k_cache, v_cache):
        raise ValueError("chunk_attention: the kernel takes plain tensors; "
                         "a sharded plan keeps attention_any")
    refuse_grad("chunk_attention", q, k_cache, v_cache)
    out = _chunk.chunk_attention(
        kernel_library()["chunk_attention"], q, k_cache, v_cache, positions,
        kv_pos, window=window, scale=q.shape[-1] ** -0.5)
    _count(chunk_attention)
    return out


chunk_attention.launches = 0


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
    if _any_dtensor(q, k, v):
        st = tuple(state) if state is not None else (None, None, None)
        h, c, n, m = _on_shards(
            "mlstm_chunk", _mlstm_chunk_flat,
            "bnsh,bnsh,bnsh,bns,bns,bnhk,bnh,bn->bnsh,bnhk,bnh,bn",
            q, k, v, i_raw, log_f, *st, chunk=chunk)
        return h, (c, n, m)
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, i_raw, log_f, state, chunk=chunk)
    refuse_grad("mlstm_chunk", q, k, v, i_raw, log_f,
                *(state if state is not None else ()))
    out = _mlstm.mlstm_chunk(
        kernel_library()["mlstm_chunk"], q, k, v, i_raw.float(),
        log_f.float(), state, chunk=chunk,
    )
    _count(mlstm_chunk)
    return out


mlstm_chunk.launches = 0


def _mlstm_chunk_flat(q, k, v, i_raw, log_f, c, n, m, *, chunk):
    """``mlstm_chunk`` with its state flattened (a local function of
    ``_on_shards``)."""
    state = None if c is None else (c, n, m)
    h, (c, n, m) = mlstm_chunk(q, k, v, i_raw, log_f, state, chunk=chunk)
    return h, c, n, m


def fused_rms_norm(x, w, eps: float):
    """``layers.rms_norm(x, w, eps)`` in one kernel: the decode block's
    ``ln1``.  x: (..., d) float32 or bf16; w: (d,) float32."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    refuse_grad("fused_rms_norm", x, w)
    out = _glue.rms_norm(kernel_library()["decode_glue"]["rms_norm"], x, w,
                         eps)
    _count(fused_rms_norm)
    return out


fused_rms_norm.launches = 0


def fused_add_rms_norm(x, residual, w, eps: float):
    """``(x + residual, layers.rms_norm(x + residual, w, eps))`` in one
    kernel: the decode block's attention residual and its ``ln2``."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps, residual)
    refuse_grad("fused_add_rms_norm", x, residual, w)
    out = _glue.rms_norm(kernel_library()["decode_glue"]["rms_norm"], x, w,
                         eps, residual)
    _count(fused_add_rms_norm)
    return out


fused_add_rms_norm.launches = 0


def rope_kv_write(q, k, v, cos, sin, pos, k_cache, v_cache, kv_pos):
    """One decode token's RoPE and cache writes in one kernel: q (B, 1,
    nh, hd) and k (B, 1, n_kv, hd) rotated by the step's ``cos``/``sin``
    (``layers.rope_tables`` at ``pos[:, None]``), k and v (B, 1, n_kv, hd)
    written into row ``clamp(pos, 0, T-1)`` of ``k_cache``/``v_cache``
    (B, T, n_kv, hd) in place, and ``pos`` into ``kv_pos`` (B, T) there.
    Returns the rotated q as a fresh contiguous (B, nh, hd), the layout
    ``paged_gqa_decode`` takes."""
    if q.device.type == "cpu":
        return rope_kv_write_ref(q, k, v, cos, sin, pos, k_cache, v_cache,
                                 kv_pos)
    refuse_grad("rope_kv_write", q, k, v, k_cache, v_cache)
    out = _glue.rope_kv_write(
        kernel_library()["decode_glue"]["rope_kv_write"], q, k, v, cos, sin,
        pos.to(torch.int32), k_cache, v_cache, kv_pos)
    _count(rope_kv_write)
    return out


rope_kv_write.launches = 0


def silu_mul(a, b):
    """``F.silu(a) * b`` in one kernel: the gated MLP's activation."""
    if a.device.type == "cpu":
        return silu_mul_ref(a, b)
    refuse_grad("silu_mul", a, b)
    out = _glue.silu_mul(kernel_library()["decode_glue"]["silu_mul"], a, b)
    _count(silu_mul)
    return out


silu_mul.launches = 0

#: every wrapper that counts its launches
COUNTED = (paged_gqa_decode, flash_prefill, chunk_attention, mlstm_chunk,
           fused_rms_norm, fused_add_rms_norm, rope_kv_write, silu_mul)


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for wrapper in COUNTED:
            wrapper.launches = 0
