#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR   # another tree's port, see below

Phases, each of which fails the run (exit code 1) on error:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is
   switched off for float32 matrix products and convolutions, so float32
   comparisons are float32;
2. build: compiles the three CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, in parallel) into
   ``build/torch_kernels`` and prints the build time, each kernel's
   register and shared-memory use and, where ``cuobjdump`` exists, the
   tensor-core instructions (HGMMA, HMMA) in each kernel's SASS; a
   tensor-core kernel (flash's, the mLSTM's two passes) without HGMMA
   fails the run;
3. kernels: every kernel against its plain PyTorch version on the same
   inputs on the card (max |d| <= 2e-5 at float32, <= 3e-2 at bfloat16, the
   tolerances of tests/test_kernels.py; flash prefill logs the path,
   tensor_core or cuda_core, that each case takes, paged decode its split;
   the chunkwise mLSTM on its output and its final state, from the empty
   and from a given state, at any length, each case on the path its rule
   gives and, where that is tensor_core, on the cuda_core kernel too; its
   float32 final state within 1e-4 where h is bfloat16); at the serving
   shapes (granite-3-2b for attention, xlstm-350m's prefill for the mLSTM,
   at 512 and 256 tokens), the median device time of the kernel, of its
   plain version and, for attention, of one
   ``scaled_dot_product_attention`` call (a yardstick the port never
   calls), timed in turns, beside the least time the card needs for the
   work; for the mLSTM also the launch floor of both passes' grids (the
   kernel of ``scripts/launch_floor.cu``, which does nothing, launched with
   their blocks, threads and shared memory), for paged decode also the
   slot caches of 100 and 97 tokens, in the pages ``Model.decode`` views
   them in;
4. reduced engines: reduced granite-3-2b and reduced xlstm-350m at float32
   served on the GPU (the kernels) and on the CPU (the plain versions)
   under three schedulers with a pool small enough to force swaps;
   completions, clock and counters must be equal, and for xlstm the
   sampled tokens too;
5. full width, granite-3-2b at bfloat16 (40 layers, d_model 2048, random
   weights from a seed) served by ``ServeEngine`` (max_batch 8, cache_len
   512, pool 4096 tokens, justitia) for seeded agents; every agent
   completes with its token budget, paged decode launched 40 times per
   decode step and flash prefill launched at all; a profiled decode step
   and a profiled prefill pass (B 8 at the largest bucket the agents
   reach) that splits the flash kernel's device time from the rest;
6. full width, xlstm-350m at bfloat16 (12 mLSTM/sLSTM pairs, d_model 1024,
   4 heads of 256) served the same way; every agent completes with its
   token budget and the mLSTM kernel is launched 12 times per prefill; a
   profiled decode step and a profiled prefill that splits the mLSTM
   kernel's time from the sLSTM loop's.

Each full-width phase zeroes the launch counts just before it serves and
reads them just after.  The last lines are the card's name and power
limit, one ``{"kernels": ...}`` JSON line and, last, ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or without the repository
beside it, the script exits non-zero and prints no result.

``--baseline DIR`` builds the kernels of the port under DIR (an earlier
commit unpacked beside this one), times its three kernels by the method
of phase 3, profiles its granite prefill pass and a decode step after it
as phase 5 does and its xlstm-350m prefill as phase 6 does, so that one
chip call can hold a change against its parent; it prints no result
line.
"""

from __future__ import annotations

import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
#: the mLSTM's final (C, n, m), float32 whatever h's type: about 100x the
#: error measured on an H100 (1e-6), well below a typical |C| of 1e-2
STATE_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
#: the check-only source of the launch-floor timing
LAUNCH_FLOOR_SOURCE = ROOT / "scripts" / "launch_floor.cu"
#: GPU clock cycles each timed call waits behind (about 1 ms), longer than
#: the host takes to enqueue any function timed here
SLEEP_CYCLES = 2_000_000
GRANITE = dict(n_layers=40, nh=32, n_kv=8, hd=64)
#: kernel functions that must hold tensor-core (HGMMA) instructions
TENSOR_CORE_KERNELS = ("flash_tc_kernel", "mlstm_chunk_states_kernel",
                       "mlstm_chunk_outputs_kernel")
#: xlstm-350m's prefill of one prompt at the longest cache
XLSTM = dict(b=1, nh=4, s=512, hd=256)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fns: dict, inputs, iters: int = 30, warmup: int = 3) -> dict:
    """Median device time of each ``fn(*inputs[i % len(inputs)])``, the
    functions timed in turns (one call of each per round) by CUDA events.
    Each timed call waits on the stream behind ``torch.cuda._sleep``, so
    the host has enqueued it before the start event runs and the events
    bracket device work only, not the host's launch overhead.  Rotating
    over several input sets larger together than the 50 MB L2 cache keeps
    each call cold, as each layer's call is on the main path."""
    import torch

    for fn in fns.values():
        for i in range(warmup):
            fn(*inputs[i % len(inputs)])
    times = {name: [] for name in fns}
    for i in range(iters):
        args = inputs[i % len(inputs)]
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def bound_ms(n_bytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa(q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call with grouped kv heads
    (a PyTorch without ``enable_gqa`` gets the kv heads repeated first)."""
    import torch
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, torch.repeat_interleave(k, rep, dim=1),
            torch.repeat_interleave(v, rep, dim=1), **kw)


# ------------------------------------------------------------------ phase 3


def check_paged(ops, ref, torch, gen, split_plan, decode_page):
    """Paged decode against its plain version; returns the max |d| at the
    granite shape in bfloat16.  The case with a length of 0 is held against
    the plain version of the split walk, which floors l as the kernel and
    the Pallas kernel do (the plain attention gives NaN there).  The slot
    caches of 100 and 97 rows are viewed as ``Model.decode`` views them, in
    pages of ``decode_page(T)`` tokens."""
    cases = [  # b, nh, n_kv, hd, page size, n_pages, max_pages, lengths
        (2, 4, 4, 64, 16, 16, 4, [1, 64]),            # MHA
        (4, 8, 2, 32, 16, 40, 6, [1, 16, 17, 96]),    # GQA, length edges
        (2, 8, 1, 128, 16, 16, 8, [16, 128]),         # MQA
        (8, 32, 8, 64, 16, 256, 32, None),            # granite, slot pages
        (3, 8, 2, 64, 16, 64, 20, "edges"),           # split edges, length 0
    ]
    for t in (100, 97):   # granite's slots at cache lengths 16 does not divide
        bs = decode_page(t)
        cases.append((8, 32, 8, 64, bs, 8 * t // bs, t // bs, None))
    # those two cases draw from a generator of their own, so that every
    # other phase-3 input is what earlier trees' runs drew (comparable)
    own = torch.Generator(device="cuda").manual_seed(100)
    granite_err = None
    for dtype in (torch.float32, torch.bfloat16):
        for b, nh, n_kv, hd, bs, n_pages, mp, lengths in cases:
            gen_case = gen if bs == 16 else own
            q = torch.randn(b, nh, hd, generator=gen_case,
                            device="cuda").to(dtype)
            kp, vp = (torch.randn(n_pages, bs, n_kv, hd, generator=gen_case,
                                  device="cuda").to(dtype) for _ in range(2))
            n_split, per = split_plan(mp, bs)
            if lengths == "edges":   # 0, and on and past a split boundary
                lengths = [0, per * bs, per * bs + 1]
            if lengths is None:   # the engine's slot-contiguous tables
                tables = torch.arange(b * mp, dtype=torch.int32,
                                      device="cuda").reshape(b, mp)
                lens = torch.randint(1, mp * bs + 1, (b,),
                                     generator=gen_case, device="cuda",
                                     dtype=torch.int32)
            else:
                tables = torch.randint(0, n_pages, (b, mp), generator=gen,
                                       device="cuda", dtype=torch.int32)
                lens = torch.tensor(lengths, dtype=torch.int32,
                                    device="cuda")
            got = ops.paged_gqa_decode(q, kp, vp, tables, lens,
                                       block_size=bs)
            qg = (q * hd ** -0.5).reshape(b, n_kv, nh // n_kv, hd)
            if lengths is not None and 0 in lengths:
                want = ref.paged_attention_split_ref(qg, kp, vp, tables,
                                                     lens, n_split)
            else:
                want = ref.paged_attention_ref(qg, kp, vp, tables, lens)
            want = want.reshape(b, nh, hd)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = str(dtype).split(".")[-1]
            log(f"  paged {name:8s} b={b} nh={nh} n_kv={n_kv} hd={hd} "
                f"page={bs} split={n_split}x{per} pages "
                f"lengths={lens.tolist()} max|d|={err:.3g}")
            if not err <= TOL[name]:
                raise AssertionError(f"paged decode differs by {err}")
            if lengths is None and bs == 16 and dtype == torch.bfloat16:
                granite_err = err
    return granite_err


def check_flash(ops, ref, torch, gen, flash_path):
    """Flash prefill against its plain version; returns the max |d| at the
    granite shape in bfloat16."""
    cases = [  # b, s, nh, n_kv, hd, window
        (1, 64, 4, 2, 32, 0),
        (8, 128, 8, 2, 64, 0),
        (1, 512, 4, 1, 128, 0),
        (8, 128, 4, 4, 64, 48),
        (1, 512, 32, 8, 64, 128),
        (8, 512, 32, 8, 64, 0),       # granite, the largest bucket
    ]
    granite_err = None
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, nh, n_kv, hd, window in cases:
            q = torch.randn(b, s, nh, hd, generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn(b, s, n_kv, hd, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            got = ops.flash_prefill(q, k, v, window=window, block_q=64,
                                    block_k=64)
            want = ref.flash_attention_ref(
                (q * hd ** -0.5).transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2), window=window,
            ).transpose(1, 2)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = str(dtype).split(".")[-1]
            log(f"  flash {name:8s} b={b} S={s} nh={nh} n_kv={n_kv} hd={hd} "
                f"window={window} path={flash_path(dtype, hd, s)} "
                f"max|d|={err:.3g}")
            if not err <= TOL[name]:
                raise AssertionError(f"flash prefill differs by {err}")
            if (b, s, nh) == (8, 512, 32) and dtype == torch.bfloat16:
                granite_err = err
    q = torch.zeros((1, 100, 2, 64), device="cuda")
    try:
        ops.flash_prefill(q, q, q, block_q=64, block_k=64)
    except ValueError:
        log("  flash S=100 with 64-token blocks: ValueError, as the Pallas "
            "contract asks")
    else:
        raise AssertionError("flash prefill accepted a misaligned S")
    return granite_err


def time_paged(ops, ref, torch, gen, t_len: int = 512, bs: int = 16):
    """Granite decode shape: B=8 slots of ``t_len`` tokens (512: 32 pages
    of ``bs`` = 16), bf16, every slot full, one layer's call; 40 distinct
    layer caches rotate to keep L2 cold."""
    b, nh, n_kv, hd = 8, GRANITE["nh"], GRANITE["n_kv"], GRANITE["hd"]
    mp = t_len // bs
    dt = torch.bfloat16
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device="cuda").reshape(b, mp)
    lens = torch.full((b,), mp * bs, dtype=torch.int32, device="cuda")
    sets = []
    for _ in range(GRANITE["n_layers"]):
        q = torch.randn(b, nh, hd, generator=gen, device="cuda").to(dt)
        kp, vp = (torch.randn(b * mp, bs, n_kv, hd, generator=gen,
                              device="cuda").to(dt) for _ in range(2))
        sets.append((q, kp, vp))
    def kernel(q, kp, vp):
        return ops.paged_gqa_decode(q, kp, vp, tables, lens, block_size=bs)

    def plain(q, kp, vp):
        qg = (q * hd ** -0.5).reshape(b, n_kv, nh // n_kv, hd)
        return ref.paged_attention_ref(qg, kp, vp, tables, lens)

    def library(q, kp, vp):
        k = kp.view(b, mp * bs, n_kv, hd).transpose(1, 2)
        v = vp.view(b, mp * bs, n_kv, hd).transpose(1, 2)
        return _sdpa(q[:, :, None], k, v)

    t = device_ms({"kernel": kernel, "plain": plain, "library": library},
                  sets)
    n_tok = int(lens.sum())
    n_bytes = (2 * n_tok * n_kv * hd * 2 + 2 * b * nh * hd * 2
               + tables.numel() * 4 + lens.numel() * 4)
    flops = 2 * 2 * n_tok * (nh // n_kv) * n_kv * hd
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=t["kernel"], plain_ms=t["plain"],
                library_ms=t["library"], bound_ms=bound, bound_by=by,
                shape=f"B={b} nh={nh} n_kv={n_kv} hd={hd} len={t_len} "
                      f"page={bs} bf16")


def time_flash(ops, ref, torch, gen):
    """Granite prefill shape: B=8, S=512 (the largest bucket), bf16, one
    layer's call; 8 distinct input sets rotate to keep L2 cold."""
    b, s, nh, n_kv, hd = 8, 512, GRANITE["nh"], GRANITE["n_kv"], GRANITE["hd"]
    dt = torch.bfloat16
    sets = []
    for _ in range(8):
        q = torch.randn(b, s, nh, hd, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, s, n_kv, hd, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        sets.append((q, k, v))
    def kernel(q, k, v):
        return ops.flash_prefill(q, k, v, block_q=64, block_k=64)

    def plain(q, k, v):
        return ref.flash_attention_ref((q * hd ** -0.5).transpose(1, 2),
                                       k.transpose(1, 2), v.transpose(1, 2))

    def library(q, k, v):
        return _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     is_causal=True)

    t = device_ms({"kernel": kernel, "plain": plain, "library": library},
                  sets, iters=20)
    n_bytes = 2 * (2 * b * s * nh * hd + 2 * b * s * n_kv * hd)
    flops = 2 * 2 * b * nh * hd * s * (s + 1) // 2   # causal pairs
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=t["kernel"], plain_ms=t["plain"],
                library_ms=t["library"], bound_ms=bound, bound_by=by,
                shape=f"B={b} S={s} nh={nh} n_kv={n_kv} hd={hd} causal bf16")


def _mlstm_inputs(torch, gen, b, h, s, hd, dtype, state: bool):
    """q, k, v as transposed views of (B, S, H, hd) tensors and the gates
    as views of (B, S, H) float32 tensors, as the model passes them."""
    q, k, v = ((torch.randn(b, s, h, hd, generator=gen, device="cuda") * 0.5)
               .to(dtype).transpose(1, 2) for _ in range(3))
    i_raw = (torch.randn(b, s, h, generator=gen, device="cuda") * 0.5
             ).transpose(1, 2)
    log_f = torch.nn.functional.logsigmoid(
        torch.randn(b, s, h, generator=gen, device="cuda") * 0.5 + 2.0
    ).transpose(1, 2)
    st = None
    if state:
        st = ((torch.randn(b, h, hd, hd, generator=gen, device="cuda") * 0.1),
              (torch.randn(b, h, hd, generator=gen, device="cuda") * 0.1),
              torch.randn(b, h, generator=gen, device="cuda"))
    return q, k, v, i_raw, log_f, st


def check_mlstm(ops, ref, torch, gen, mlstm):
    """The chunkwise mLSTM against its plain version on its output and its
    final (C, n, m), each case on the instantiation its rule gives
    (``mlstm.mlstm_path``) and, where that is tensor_core, on the cuda_core
    kernel too; h within ``TOL``, the float32 state within ``STATE_TOL``;
    returns the max |d| on h at xlstm-350m's prefill shape in bfloat16 on
    the rule's path."""
    x = XLSTM
    cases = [  # b, h, s, hd, chunk, with a state
        (2, 2, 64, 32, 16, False),     # the shapes of tests/test_kernels.py
        (1, 3, 128, 64, 32, False),
        (1, 1, 96, 128, 32, False),
        (2, 1, 64, 256, 64, False),
        (1, 4, 100, 256, 64, False),   # hd 256, ragged last chunks
        (1, 4, 257, 256, 64, False),
        (1, 4, 257, 256, 64, True),    # from a given state
        (2, 2, 37, 32, 64, True),
        (2, 2, 200, 128, 64, True),
        (1, 2, 1100, 256, 64, True),   # more chunks than the states ring
        (x["b"], x["nh"], x["s"], x["hd"], 64, False),   # xlstm-350m
    ]
    fn = ops.kernel_library()["mlstm_chunk"]
    xlstm_err = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, h, s, hd, chunk, with_state in cases:
            args = _mlstm_inputs(torch, gen, b, h, s, hd, dtype, with_state)
            want, want_st = ref.mlstm_chunk_ref(*args, chunk=chunk)
            rule = mlstm.mlstm_path(dtype, hd, chunk)
            paths = [rule] + (["cuda_core"] if rule == "tensor_core" else [])
            for path in paths:
                if path == rule:
                    got, got_st = ops.mlstm_chunk(*args, chunk=chunk)
                else:
                    got, got_st = mlstm.mlstm_chunk(fn, *args, chunk=chunk,
                                                    path=path)
                torch.cuda.synchronize()
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip((got, *got_st), (want, *want_st))]
                log(f"  mlstm {name:8s} b={b} h={h} S={s} hd={hd} "
                    f"chunk={chunk} state={'given' if with_state else 'empty'}"
                    f" path={path}{'' if path == rule else ' (forced)'} "
                    f"max|d| h={errs[0]:.3g} C={errs[1]:.3g} n={errs[2]:.3g} "
                    f"m={errs[3]:.3g}")
                if not (errs[0] <= TOL[name]
                        and max(errs[1:]) <= STATE_TOL[name]):
                    raise AssertionError(
                        f"mlstm_chunk ({path}) differs by {errs} (h, C, n, "
                        f"m)")
                if (b, h, s, hd) == (x["b"], x["nh"], x["s"], x["hd"]) and \
                        dtype == torch.bfloat16 and path == rule:
                    xlstm_err = errs[0]
    return xlstm_err


def time_mlstm(ops, ref, torch, gen, s: int = XLSTM["s"], floor=None):
    """xlstm-350m's prefill shape: one prompt of ``s`` tokens, 4 heads of
    256, bf16 q/k/v, float32 gates, from the empty state as prefill starts;
    one layer's call through the wrapper, with q, k, v and the gates in the
    layout the model passes them (transposed views), so that whatever the
    wrapper launches for them is timed with the kernel; 16 input sets
    rotating to keep L2 cold.  ``floor`` (``build_launch_floor``'s entry
    point) also times a kernel that does nothing, launched with the blocks,
    threads and shared memory of the tensor-core passes: their launch
    floor."""
    x = XLSTM
    b, h, hd = x["b"], x["nh"], x["hd"]
    sets = [_mlstm_inputs(torch, gen, b, h, s, hd, torch.bfloat16,
                          False)[:5] for _ in range(16)]
    fns = {"kernel": lambda *a: ops.mlstm_chunk(*a),
           "plain": lambda *a: ref.mlstm_chunk_ref(*a)}
    if floor is not None:
        import ctypes

        from repro_torch.kernels import mlstm_chunk as mlstm

        passes = ("states", "outputs")
        blocks = mlstm.grids(b, h, s, hd, "tensor_core")
        args = [(ctypes.c_int * 2)(*vals) for vals in (
            [blocks[p] for p in passes], [mlstm.THREADS[p] for p in passes],
            [mlstm.smem_bytes(hd, kernel=p) for p in passes])]

        def empty_grids(*_):
            err = floor(2, *args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch floor: CUDA error {err}")

        fns["floor"] = empty_grids
    t = device_ms(fns, sets, iters=20)
    chunk = 64
    lens = [min(chunk, s - t0) for t0 in range(0, s, chunk)]
    # inputs read once (q, k, v bf16; gates f32), h written in bf16 and the
    # final state in f32
    n_bytes = (3 * 2 + 2) * b * h * s * hd + 2 * 4 * b * h * s + 4 * b * h * (
        hd * hd + hd + 1)
    # per (b, h): causal q.k^T and (q.k^T * w).v within each chunk, q.C0
    # and the C update per token, q.n0 and the n update per token
    flops = b * h * (2 * 2 * hd * sum(n * (n + 1) // 2 for n in lens)
                     + 2 * 2 * s * hd * hd + 2 * 2 * s * hd)
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
                bound_ms=bound, bound_by=by, floor_ms=t.get("floor"),
                shape=f"B={b} H={h} S={s} hd={hd} chunk={chunk} bf16 q/k/v, "
                      "f32 gates and state, empty state in")


def log_timing(name: str, t: dict) -> None:
    lib = ("none" if t["library_ms"] is None
           else f"{t['library_ms']:.4f} ms")
    floor = ("" if t.get("floor_ms") is None
             else f", launch floor of its grids {t['floor_ms']:.4f} ms")
    log(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library call {lib}, bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
        f"(kernel at {t['bound_ms'] / t['ms']:.3%} of the bound){floor}")


# ---------------------------------------------------------- phases 4 and 5


def seeded_agents(agent_cls, inference_spec, agent_cost, seed, n, p_range,
                  d_range, vocab):
    import numpy as np

    rng = np.random.default_rng(seed)
    agents, budgets = [], {}
    for i in range(n):
        stages, specs = [], []
        for _ in range(1 + int(rng.integers(0, 2))):
            stage = []
            for _ in range(1 + int(rng.integers(0, 2))):
                p = int(rng.integers(*p_range))
                d = int(rng.integers(*d_range))
                stage.append((rng.integers(0, vocab, size=p), d))
                specs.append(inference_spec(p, d))
            stages.append(stage)
        budgets[i] = sum(s.decode for s in specs)
        agents.append(agent_cls(i, int(rng.integers(0, 2 * n)), stages,
                                agent_cost(specs)))
    return agents, budgets


def serving_agents(pkg, vocab: int):
    """The 8 seeded agents the full-width phases serve (prompts of 64-400
    tokens, 16-64 new tokens each)."""
    return seeded_agents(pkg["EngineAgent"], pkg["InferenceSpec"],
                         pkg["agent_cost"], 2026, 8, (64, 401), (16, 65),
                         vocab)


class TokenLog:
    def __init__(self):
        self.tokens = {}

    def on_token(self, aid, rid, tok, t):
        self.tokens.setdefault(aid, []).append(int(tok))


def reduced_engine(torch, pkg, arch: str, **over):
    """A reduced config at f32 on the GPU (kernels) and the CPU (plain).
    For the ssm family the sampled tokens must be equal too."""
    import numpy as np

    cfg = pkg["get_config"](arch).reduced(**over)
    cpu_model = pkg["Model"](cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    gpu_model = pkg["Model"](cfg, device="cuda", debug_checks=True)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        return tree.to("cuda")

    gpu_params = to_cuda(cpu_params)
    for sched in ("justitia", "vtc", "vllm-fcfs"):
        runs = []
        for model, params, dev in ((gpu_model, gpu_params, "cuda"),
                                   (cpu_model, cpu_params, "cpu")):
            toks = TokenLog()
            eng = pkg["ServeEngine"](
                model, params, pkg["make_scheduler"](sched, 256.0),
                pool_tokens=256, max_batch=4, cache_len=128, listener=toks,
                device=dev,
            )
            agents, _ = seeded_agents(pkg["EngineAgent"],
                                      pkg["InferenceSpec"],
                                      pkg["agent_cost"], 5, 8, (16, 64),
                                      (24, 60), cfg.vocab)
            for a in agents:
                eng.submit_agent(a)
            eng.run_until_idle()
            eng.alloc.check_invariants()
            runs.append(({"completions": dict(eng.completions),
                          "now": eng.now,
                          **{k: eng.metrics[k] for k in
                             ("tokens", "prefills", "swaps",
                              "decode_steps")}}, toks.tokens))
        (g, gt), (c, ct) = runs
        flat_g = np.concatenate([gt[a] for a in sorted(gt)])
        flat_c = np.concatenate([ct[a] for a in sorted(ct)])
        match = float(np.mean(flat_g == flat_c)) if len(flat_g) == len(
            flat_c) else 0.0
        log(f"  {arch} {sched:9s} gpu={g} cpu_equal={g == c} "
            f"token_match={match:.4f}")
        if g != c:
            raise AssertionError(f"GPU and CPU engines differ: {g} vs {c}")
        if g["swaps"] == 0:
            raise AssertionError("pool 256 did not force a swap")
        if cfg.kind == "ssm" and match != 1.0:
            raise AssertionError(f"sampled tokens differ: match {match}")


def full_width(torch, pkg, ops, arch: str):
    """Serve ``arch`` at full width from random weights; returns the launch
    counts of the family's kernels over the serving run."""
    cfg = pkg["get_config"](arch)
    ssm = cfg.kind == "ssm"
    # an earlier phase's engine is freed only by the cycle collector (its
    # timed methods refer back to it): collect it, so that the peak memory
    # below is this phase's own
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = pkg["Model"](cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab} {cfg.dtype}; "
        f"{n_params / 1e9:.3f} B parameters from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    toks = TokenLog()
    eng = pkg["ServeEngine"](
        model, params, pkg["make_scheduler"]("justitia", 4096.0),
        pool_tokens=4096, max_batch=8, cache_len=512, listener=toks,
    )
    eng.warmup()
    agents, budgets = serving_agents(pkg, cfg.vocab)
    for a in agents:
        eng.submit_agent(a)
    wall = {"prefill": 0.0, "decode": 0.0}

    def timed(fn, key):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            wall[key] += time.perf_counter() - t
            return out
        return run

    # both end in a device->host copy of sampled tokens; the sync is a
    # no-op that makes the host clock honest
    eng._prefill_batch = timed(eng._prefill_batch, "prefill")
    eng._decode_once = timed(eng._decode_once, "decode")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"paged_attention": ops.paged_gqa_decode.launches,
                "flash_attention": ops.flash_prefill.launches,
                "mlstm_chunk": ops.mlstm_chunk.launches}
    m = eng.metrics
    peak = torch.cuda.max_memory_allocated()
    log(f"  agents={len(agents)} completed={len(done)} now={eng.now} "
        f"prefills={m['prefills']} swaps={m['swaps']} "
        f"decode_steps={m['decode_steps']} windows={m['windows']} "
        f"tokens={m['tokens']}")
    log(f"  wall: total={total:.3f} s prefill={wall['prefill']:.3f} s "
        f"decode={wall['decode']:.3f} s; "
        f"decode iterations/s={m['decode_steps'] / wall['decode']:.2f} "
        f"tokens/s={m['tokens'] / total:.2f} "
        f"peak memory={peak / 2**30:.3f} GiB")
    if ssm:
        n_pairs = cfg.n_layers // cfg.slstm_every
        want = {"mlstm_chunk": n_pairs * m["prefills"]}
        log(f"  launches: {launches} (mlstm_chunk = {n_pairs} pairs x "
            f"{m['prefills']} prefills: "
            f"{launches['mlstm_chunk'] == want['mlstm_chunk']})")
    else:
        want = {"paged_attention": cfg.n_layers * m["decode_steps"]}
        log(f"  launches: {launches} (paged_gqa_decode = {cfg.n_layers} "
            f"layers x {m['decode_steps']} decode steps: "
            f"{launches['paged_attention'] == want['paged_attention']})")
    if set(done) != set(budgets):
        raise AssertionError(f"agents {set(budgets) - set(done)} did not "
                             "complete")
    for aid, budget in budgets.items():
        got = len(toks.tokens.get(aid, []))
        if got != budget:
            raise AssertionError(f"agent {aid}: {got} tokens, budget "
                                 f"{budget}")
        if not all(0 <= t < cfg.vocab for t in toks.tokens[aid]):
            raise AssertionError(f"agent {aid}: token id out of range")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"not {n}")
    if not ssm and launches["flash_attention"] <= 0:
        raise AssertionError("flash prefill never launched")
    # one more decode step on the final cache: finite logits of the
    # expected shape
    logits, _ = model.decode(params, eng.cache,
                             eng._d_state[0][:, None].clone(),
                             eng._d_state[1].clone())
    if logits.shape != (8, 1, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError("full-width logits are not finite")
    profile_decode(torch, model, params, eng.cache,
                   eng._d_state[0][:, None].clone(), eng._d_state[1].clone())
    if ssm:
        profile_prefill(torch, model, params)
        return {"mlstm_chunk": launches["mlstm_chunk"]}
    profile_granite_prefill(torch, model, params, 8, largest_bucket(agents))
    return {k: launches[k] for k in ("paged_attention", "flash_attention")}


def _device_rows(prof, per: int):
    """(device us per ``per``, calls per ``per``, name) of every kernel in
    a ``torch.profiler`` run; operator rows are left out, as they repeat
    their kernels' time."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / per, ev.count // per, ev.key))
    return rows


def profile_decode(torch, model, params, cache, toks, pos, steps: int = 4):
    """Where a full-width decode step's time goes: host wall per step, the
    kernels launched per step, the device's busy time (sum of kernel times)
    and the kernels that take most of it, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode(params, cache, toks, pos)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / steps * 1e6
    rows = _device_rows(prof, steps)
    busy = sum(r[0] for r in rows)
    log(f"  profile: decode step wall {wall_us:.0f} us (profiler on), "
        f"{sum(r[1] for r in rows)} kernels/step, device busy {busy:.0f} "
        f"us, idle share {1 - busy / wall_us:.3f}" if busy else
        "  profile: the profiler recorded no device time (not measured)")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev:9.1f} us/step {count:5d} calls/step  {key[:70]}")


def profile_prefill(torch, model, params, s: int = 256):
    """Where a full-width xLSTM prefill of one ``s``-token prompt goes: the
    host wall of its mLSTM and sLSTM calls (each ended by a synchronize),
    then, from ``torch.profiler``, the device time of the mLSTM kernel
    against all device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (1, s), generator=gen,
                         device="cuda", dtype=torch.int32)
    orig = {"mlstm": ssm.mlstm_forward_chunked, "slstm": ssm.slstm_forward}
    wall = dict.fromkeys(orig, 0.0)

    def timed(key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[key](*args, **kw)
            torch.cuda.synchronize()
            wall[key] += time.perf_counter() - t
            return out
        return run

    ssm.mlstm_forward_chunked, ssm.slstm_forward = (timed("mlstm"),
                                                    timed("slstm"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache_len=512)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        ssm.mlstm_forward_chunked = orig["mlstm"]
        ssm.slstm_forward = orig["slstm"]
    log(f"  prefill of {s} tokens: wall {total * 1e3:.1f} ms; mLSTM calls "
        f"{wall['mlstm'] * 1e3:.1f} ms ({wall['mlstm'] / total:.3f}), "
        f"sLSTM loops {wall['slstm'] * 1e3:.1f} ms "
        f"({wall['slstm'] / total:.3f}), the rest "
        f"{(total - wall['mlstm'] - wall['slstm']) * 1e3:.1f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache_len=512)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    mlstm = [r for r in rows if "mlstm_chunk" in r[2]]
    if not busy:
        log("  profile: the profiler recorded no device time (not measured)")
        return
    log(f"  profile: prefill wall {wall_us:.0f} us (profiler on), device "
        f"busy {busy:.0f} us, idle share {1 - busy / wall_us:.3f}; "
        f"mlstm_chunk kernel {sum(r[0] for r in mlstm):.0f} us in "
        f"{sum(r[1] for r in mlstm)} calls, the other kernels "
        f"{busy - sum(r[0] for r in mlstm):.0f} us in "
        f"{sum(r[1] for r in rows) - sum(r[1] for r in mlstm)} calls")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev:9.1f} us {count:6d} calls  {key[:70]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def sass_counts(lib: Path):
    """Tensor-core instructions in each kernel function of a built library,
    ``{function: {"HGMMA": n, "HMMA": n}}`` from ``cuobjdump -sass``; None
    where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if op + "." in line:
                    counts[fn][op] += 1
                    break
    names = list(counts)
    filt = shutil.which("c++filt")
    if filt and names:
        shown = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(shown) == len(names):
            counts = {short: counts[n] for short, n in zip(shown, names)}
    return counts


def build_launch_floor(ops):
    """Start ``nvcc`` on ``scripts/launch_floor.cu`` (a check-only kernel
    that does nothing) into the kernels' build directory; returns a function
    that waits for it and returns its loaded C entry point, so that the
    build runs beside the port's."""
    import ctypes

    ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = ops.BUILD_DIR / "launch_floor.so"
    proc = subprocess.Popen(
        [ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib),
         str(LAUNCH_FLOOR_SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"launch_floor.cu build failed:\n{out}")
        fn = ctypes.CDLL(str(lib)).launch_floor
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        return fn

    return load


def largest_bucket(agents) -> int:
    """The largest 64-token prefill bucket the agents' prompts reach."""
    longest = max(len(p) for a in agents for stage in a.stages
                  for p, _ in stage)
    return -(-longest // 64) * 64


def profile_granite_prefill(torch, model, params, b: int, s: int) -> dict:
    """Where one full-width granite prefill pass of ``b`` prompts of ``s``
    tokens goes (the engine's one-shot bucketed prefill): the host wall
    after a synchronize, then, from ``torch.profiler``, the flash kernel's
    device time against all device time of the pass."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (b, s),
                                     generator=gen, device="cuda")}
    model.prefill(params, batch, cache_len=512)   # warm the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, batch, cache_len=512)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(params, batch, cache_len=512)
        torch.cuda.synchronize()
    rows = _device_rows(prof, 1)
    busy = sum(r[0] for r in rows)
    flash = [r for r in rows if "flash" in r[2]]
    flash_us = sum(r[0] for r in flash)
    log(f"  prefill pass B={b} S={s}: wall {wall_ms:.2f} ms")
    if not busy:
        log("  profile: the profiler recorded no device time (not measured)")
        return {"wall_ms": wall_ms}
    log(f"  profile: device busy {busy:.0f} us; flash kernel {flash_us:.0f} "
        f"us in {sum(r[1] for r in flash)} calls ({flash_us / busy:.3f} of "
        f"the busy time), the other kernels {busy - flash_us:.0f} us in "
        f"{sum(r[1] for r in rows) - sum(r[1] for r in flash)} calls")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev:9.1f} us {count:6d} calls  {key[:70]}")
    return {"wall_ms": wall_ms, "busy_us": busy, "flash_us": flash_us}


# --------------------------------------------------------------------- main


def run_baseline(torch, pkg, ops, ref, tree: Path) -> int:
    """The before side of a comparison made in one chip call: times the
    kernels of another tree's port (an earlier commit unpacked beside this
    one) by this script's methods, profiles its granite prefill pass and a
    decode step, and its xlstm-350m prefill.  Prints no result line."""
    log(f"== baseline: the port under {tree}")
    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.kernel_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    log_timing("paged_attention", time_paged(ops, ref, torch, gen))
    log_timing("flash_attention", time_flash(ops, ref, torch, gen))
    for s_len in (XLSTM["s"], 256):
        log_timing("mlstm_chunk", time_mlstm(ops, ref, torch, gen, s_len))
    cfg = pkg["get_config"]("granite-3-2b")
    model = pkg["Model"](cfg, device="cuda")
    params = model.init(seed=0)
    agents, _ = serving_agents(pkg, cfg.vocab)
    s = largest_bucket(agents)
    profile_granite_prefill(torch, model, params, 8, s)
    # a decode step of 8 slots after a prefill of s tokens, as phase 5
    # profiles one
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (8, s), generator=gen, device="cuda")
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=512)
    profile_decode(torch, model, params, cache, toks[:, -1:].clone(),
                   torch.full((8,), s, dtype=torch.int32, device="cuda"))
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    xlstm = pkg["Model"](pkg["get_config"]("xlstm-350m"), device="cuda")
    profile_prefill(torch, xlstm, xlstm.init(seed=0))
    return 0


def main(argv: list) -> int:
    """``chip_smoke.py``: the smoke run; ``chip_smoke.py --baseline DIR``:
    ``run_baseline`` on the port under DIR."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    tree = ROOT
    if argv:
        if len(argv) != 2 or argv[0] != "--baseline":
            print("usage: chip_smoke.py [--baseline DIR]", file=sys.stderr)
            return 2
        tree = Path(argv[1]).resolve()
    src = tree / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.core import (
        InferenceSpec,
        agent_cost,
        make_scheduler,
    )
    from repro_torch.engine import EngineAgent, ServeEngine
    from repro_torch.kernels import ops, ref
    from repro_torch.models import Model

    pkg = dict(get_config=get_config, InferenceSpec=InferenceSpec,
               agent_cost=agent_cost, make_scheduler=make_scheduler,
               EngineAgent=EngineAgent, ServeEngine=ServeEngine, Model=Model)
    if argv:
        return run_baseline(torch, pkg, ops, ref, tree)
    from repro_torch.kernels import mlstm_chunk as mlstm
    from repro_torch.kernels.flash_attention import flash_path
    from repro_torch.kernels.flash_attention import smem_bytes as flash_smem
    from repro_torch.kernels.paged_attention import smem_bytes as paged_smem
    from repro_torch.kernels.paged_attention import split_plan
    from repro_torch.models.transformer import decode_page

    log("== 1. device")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off for float32 matmuls and convolutions")

    log("== 2. build")
    t0 = time.perf_counter()
    load_floor = build_launch_floor(ops)
    ops.kernel_library()
    floor = load_floor()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for path in sorted(ops.BUILD_DIR.glob("*.log")):
        for line in path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {path.stem}: {line.strip()}")
    for name, mod in ops._KERNELS.items():
        counts = sass_counts(ops._library_path(mod.SOURCE))
        if counts is None:
            log("  cuobjdump not found: tensor-core instruction counts not "
                "measured")
            break
        for fn, c in counts.items():
            log(f"  {name} SASS: HGMMA {c['HGMMA']:4d} HMMA {c['HMMA']:4d}"
                f"  {fn[:90]}")
            if any(t in fn for t in TENSOR_CORE_KERNELS) and not c["HGMMA"]:
                raise AssertionError(f"tensor-core kernel {fn} has no HGMMA")
    g, hd = GRANITE, XLSTM["hd"]
    qpk = g["nh"] // g["n_kv"]
    log(f"  dynamic shared memory per block: paged_attention "
        f"{paged_smem(qpk, g['hd'])} bytes (qpk {qpk}, hd {g['hd']}; "
        f"{split_plan(512 // 16)[0]} blocks per slot and kv head), "
        f"flash_attention {flash_smem(g['hd'], path='tensor_core', qpk=qpk)}"
        f" bytes (tensor_core, hd {g['hd']}, qpk {qpk}) and "
        f"{flash_smem(g['hd'])} bytes (cuda_core), "
        f"mlstm_chunk (hd {hd}) {mlstm.smem_bytes(hd, kernel='states')} "
        f"bytes (states pass), {mlstm.smem_bytes(hd, kernel='outputs')} "
        f"bytes (outputs pass), {mlstm.smem_bytes(hd)} bytes (cuda_core); "
        f"blocks at xlstm-350m's prefill "
        f"{mlstm.grids(1, XLSTM['nh'], XLSTM['s'], hd, 'tensor_core')} "
        f"(tensor_core), "
        f"{mlstm.grids(1, XLSTM['nh'], XLSTM['s'], hd, 'cuda_core')}")

    log("== 3. kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"paged_attention": check_paged(ops, ref, torch, gen, split_plan,
                                          decode_page),
           "flash_attention": check_flash(ops, ref, torch, gen, flash_path),
           "mlstm_chunk": check_mlstm(ops, ref, torch, gen, mlstm)}
    timing = {"paged_attention": time_paged(ops, ref, torch, gen),
              "flash_attention": time_flash(ops, ref, torch, gen),
              "mlstm_chunk": time_mlstm(ops, ref, torch, gen, floor=floor)}
    for name, t in timing.items():
        log_timing(name, t)
    # the prompt phase 6 profiles
    log_timing("mlstm_chunk", time_mlstm(ops, ref, torch, gen, 256,
                                         floor=floor))
    # slot caches that 16 does not divide, in the pages Model.decode views
    # them in (a generator of their own, as check_paged's)
    own = torch.Generator(device="cuda").manual_seed(100)
    for t_len in (100, 97):
        log_timing("paged_attention", time_paged(ops, ref, torch, own, t_len,
                                                 decode_page(t_len)))

    log("== 4. reduced engines, GPU (kernels) against CPU (plain)")
    reduced_engine(torch, pkg, "granite-3-2b")
    reduced_engine(torch, pkg, "xlstm-350m", n_layers=4)

    log("== 5. full-width granite-3-2b")
    launches = full_width(torch, pkg, ops, "granite-3-2b")

    log("== 6. full-width xlstm-350m")
    launches.update(full_width(torch, pkg, ops, "xlstm-350m"))

    sources = {
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:125"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:125"),
        "mlstm_chunk": ("src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                        "src/repro/kernels/mlstm_chunk.py:127"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception as exc:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
