#!/usr/bin/env python3
"""Where the time of the port's two attention kernels goes, on one GPU.

    python3 scripts/ablate_attention_torch.py

Builds variants of ``src/repro_torch/kernels/csrc/paged_attention.cu`` and
``flash_attention.cu`` with parts of the kernel cut out (by text edits of
a copy, into ``build/ablate/``; each variant computes a wrong answer and
is only timed), then times every variant beside the unchanged kernel and
one ``scaled_dot_product_attention`` call at granite-3-2b's shapes: paged
decode at B=8 slots of 512 tokens, flash prefill at B=8, S=512, both bf16.
Times are device times, as ``chip_smoke.py`` takes them: the functions in
turns, each call queued behind ``torch.cuda._sleep`` so that the host's
launch is not timed, inputs rotating through more than the L2 cache.

Paged variants: ``empty`` (the launch alone), ``no_kv`` (no K/V loads),
``no_cluster_merge`` (the block's partial only), ``no_merges`` (neither
the block's nor the cluster's merge), and the unchanged kernel at splits
of 8, 4 and 1 blocks.  Flash variants: ``no_softmax`` and
``loads_stores_only`` (no products, no softmax).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablate"
SLEEP_CYCLES = 2_000_000
B, NH, N_KV, HD, S, PAGES, BS = 8, 32, 8, 64, 512, 32, 16


def cut(src: str, start: str, end: str, keep_end: bool = True) -> str:
    """``src`` without the text from ``start`` up to ``end``."""
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + src[j if keep_end else j + len(end):]


def paged_variants(src: str) -> dict:
    merge_start = "  // the cluster's merge, its outputs spread over"
    merges_start = "  // the block's partial: the groups of each warp merge"
    last_sync = ("  // no block leaves while another may still read its "
                 "shared memory\n  cluster.sync();\n")
    kernel_end = "template <typename T, int QT>\nint launch_qt("
    # a use of every partial, so that the compiler keeps the walk's work
    keep = ("  float used = 0.f;\n"
            "  for (int i = 0; i < QT; ++i) {\n"
            "    used += m[i] + l[i];\n"
            "    for (int d = 0; d < 8; ++d) used += acc[i][d];\n"
            "  }\n"
            "  if (used == 1234.5f) out[q_off] = from_f32<T>(used);\n}\n\n")
    keep_block = ("  if (b_acc[0] == 1234.5f) "
                  "out[q_off] = from_f32<T>(b_ml[0]);\n")
    return {
        "base": src,
        "empty": src.replace("  constexpr int U = Unroll<T>::n;\n",
                             "  constexpr int U = Unroll<T>::n;\n"
                             "  if (n_kv > 0) return;\n", 1),
        "no_kv": src.replace(
            "        kx[u].load(k_pages + off);\n"
            "        vx[u].load(v_pages + off);\n",
            "        kx[u].zero();\n        vx[u].zero();\n"
            "        if (off == -1) kx[u].load(k_pages);\n", 1),
        "no_cluster_merge": cut(src, merge_start, last_sync,
                                keep_end=False).replace(
            "}\n\n" + kernel_end, keep_block + "}\n\n" + kernel_end, 1),
        "no_merges": cut(src, merges_start, kernel_end).replace(
            kernel_end, keep + kernel_end, 1),
    }


def flash_variants(src: str) -> dict:
    softmax = ("      // mask the diagonal tile and the window's left edge",
               "      // O += P V, P as bf16 A fragments")
    s_loop = ("#pragma unroll\n      for (int kk = 0; kk < KSTEPS; ++kk) {",
              "      wg_commit();")
    pv_loop = ("#pragma unroll\n      for (int kk = 0; kk < 4; ++kk) {\n"
               "        // V tile read MN-major", "      wg_commit();")
    no_softmax = cut(src, *softmax)
    return {
        "base": src,
        "no_softmax": no_softmax,
        "loads_stores_only": cut(cut(no_softmax, *s_loop), *pv_loop),
    }


def build(kind: str, variants: dict, argtypes, nvcc: str) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu = OUT / f"{kind}_{name}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{kind} {name} did not build:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{kind}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_us(torch, fns: dict, inputs, iters: int = 30) -> dict:
    for fn in fns.values():
        for args in inputs[:3]:
            fn(*args)
    times = {name: [] for name in fns}
    for i in range(iters):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn(*inputs[i % len(inputs)])
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ablate_attention_torch: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    paged = build("paged_attention", paged_variants(
        (CSRC / "paged_attention.cu").read_text()), pa.ARGTYPES, ops._nvcc())
    flash = build("flash_attention", flash_variants(
        (CSRC / "flash_attention.cu").read_text()), fa.ARGTYPES, ops._nvcc())
    dt = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream

    tables = torch.arange(B * PAGES, dtype=torch.int32,
                          device="cuda").view(B, PAGES)
    lens = torch.full((B,), PAGES * BS, dtype=torch.int32, device="cuda")
    dec = [(torch.randn(B, NH, HD, device="cuda").to(dt),
            *(torch.randn(B * PAGES, BS, N_KV, HD, device="cuda").to(dt)
              for _ in range(2))) for _ in range(40)]

    def paged_call(fn, split):
        def run(q, kp, vp):
            qg = q.view(B, N_KV, NH // N_KV, HD)
            out = torch.empty_like(qg)
            err = fn(qg.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                     tables.data_ptr(), lens.data_ptr(), out.data_ptr(), B,
                     N_KV, NH // N_KV, HD, B * PAGES, BS, PAGES, 1, stream,
                     HD ** -0.5, *split)
            assert not err, err
        return run

    def sdpa_decode(q, kp, vp):
        k = kp.view(B, PAGES * BS, N_KV, HD).transpose(1, 2)
        v = vp.view(B, PAGES * BS, N_KV, HD).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              enable_gqa=True)

    plan = pa.split_plan(PAGES)
    fns = {"sdpa": sdpa_decode}
    for name, fn in paged.items():
        fns[f"{name} {plan[0]}x{plan[1]}"] = paged_call(fn, plan)
    for split in ((8, 4), (1, 32)):
        fns[f"base {split[0]}x{split[1]}"] = paged_call(paged["base"], split)
    print(f"paged decode, B={B} x {PAGES * BS} tokens, n_kv {N_KV}, qpk "
          f"{NH // N_KV}, hd {HD}, bf16 (device us, median):")
    for name, t in device_us(torch, fns, dec).items():
        print(f"  {name:28s} {t:8.2f}", flush=True)

    pre = []
    for _ in range(8):
        q = torch.randn(B, S, NH, HD, device="cuda").to(dt)
        k, v = (torch.randn(B, S, N_KV, HD, device="cuda").to(dt)
                for _ in range(2))
        pre.append((q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))

    def flash_call(fn):
        def run(q, k, v):
            out = torch.empty((B, S, NH, HD), dtype=dt,
                              device="cuda").transpose(1, 2)
            st = (ctypes.c_int64 * 9)(
                *(t.stride(i) for t in (q, k, out) for i in (0, 1, 2)))
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, NH, S, NH // N_KV, HD, 0,
                     ctypes.addressof(st), 1, stream, HD ** -0.5,
                     fa.tc_heads(NH // N_KV, HD))
            assert not err, err
        return run

    fns = {"sdpa": lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)}
    for name, fn in flash.items():
        fns[name] = flash_call(fn)
    print(f"flash prefill, B={B}, S={S}, {NH}/{N_KV} heads, hd {HD}, causal, "
          "bf16 (device us, median):")
    for name, t in device_us(torch, fns, pre, iters=20).items():
        print(f"  {name:28s} {t:8.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
