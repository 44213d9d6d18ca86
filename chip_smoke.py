#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on error:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is
   switched off for float32 matrix products and convolutions, so float32
   comparisons are float32;
2. build: compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   into ``build/torch_kernels`` and prints the build time and each kernel's
   register and shared-memory use;
3. kernels: every kernel against its plain PyTorch version on the same
   inputs on the card (max |d| <= 2e-5 at float32, <= 3e-2 at bfloat16, the
   tolerances of tests/test_kernels.py); at granite-3-2b's serving shapes,
   the median time of the kernel, of its plain version and of one
   ``scaled_dot_product_attention`` call (a yardstick the port never
   calls), beside the least time the card needs for the work;
4. reduced engine: reduced granite-3-2b at float32 served on the GPU (the
   kernels) and on the CPU (the plain versions) under three schedulers with
   a pool small enough to force swaps; completions, clock and counters must
   be equal;
5. full width: granite-3-2b at bfloat16 (40 layers, d_model 2048, random
   weights from a seed) served by ``ServeEngine`` (max_batch 8, cache_len
   512, pool 4096 tokens, justitia) for seeded agents; every agent
   completes with its token budget, paged decode launched 40 times per
   decode step and flash prefill launched at all.

The last lines are the card's name and power limit, one ``{"kernels": ...}``
JSON line and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
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
GRANITE = dict(n_layers=40, nh=32, n_kv=8, hd=64)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, inputs, iters: int = 30, warmup: int = 3) -> float:
    """Median time of ``fn(*inputs[i % len(inputs)])`` by CUDA events.
    Rotating over several input sets larger together than the 50 MB L2
    cache keeps each call cold, as each layer's call is on the main path."""
    import torch

    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    times = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def check_paged(ops, ref, torch, gen):
    """Paged decode against its plain version; returns the max |d| at the
    granite shape in bfloat16."""
    cases = [  # b, nh, n_kv, hd, n_pages, max_pages, lengths
        (2, 4, 4, 64, 16, 4, [1, 64]),            # MHA
        (4, 8, 2, 32, 40, 6, [1, 16, 17, 96]),    # GQA, length edges
        (2, 8, 1, 128, 16, 8, [16, 128]),         # MQA
        (8, 32, 8, 64, 256, 32, None),            # granite, slot pages
    ]
    granite_err = None
    for dtype in (torch.float32, torch.bfloat16):
        for b, nh, n_kv, hd, n_pages, mp, lengths in cases:
            q = torch.randn(b, nh, hd, generator=gen, device="cuda").to(dtype)
            kp, vp = (torch.randn(n_pages, 16, n_kv, hd, generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            if lengths is None:   # the engine's slot-contiguous tables
                tables = torch.arange(b * mp, dtype=torch.int32,
                                      device="cuda").reshape(b, mp)
                lens = torch.randint(1, mp * 16 + 1, (b,), generator=gen,
                                     device="cuda", dtype=torch.int32)
            else:
                tables = torch.randint(0, n_pages, (b, mp), generator=gen,
                                       device="cuda", dtype=torch.int32)
                lens = torch.tensor(lengths, dtype=torch.int32,
                                    device="cuda")
            got = ops.paged_gqa_decode(q, kp, vp, tables, lens)
            qg = (q * hd ** -0.5).reshape(b, n_kv, nh // n_kv, hd)
            want = ref.paged_attention_ref(qg, kp, vp, tables,
                                           lens).reshape(b, nh, hd)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = str(dtype).split(".")[-1]
            log(f"  paged {name:8s} b={b} nh={nh} n_kv={n_kv} hd={hd} "
                f"lengths={lens.tolist()} max|d|={err:.3g}")
            if not err <= TOL[name]:
                raise AssertionError(f"paged decode differs by {err}")
            if lengths is None and dtype == torch.bfloat16:
                granite_err = err
    return granite_err


def check_flash(ops, ref, torch, gen):
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
                f"window={window} max|d|={err:.3g}")
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


def time_paged(ops, ref, torch, gen):
    """Granite decode shape: B=8 slots of 512 tokens (32 pages), bf16, one
    layer's call; 40 distinct layer caches rotate to keep L2 cold."""
    b, nh, n_kv, hd = 8, GRANITE["nh"], GRANITE["n_kv"], GRANITE["hd"]
    mp, bs = 32, 16
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
    kernel = median_ms(lambda q, kp, vp: ops.paged_gqa_decode(
        q, kp, vp, tables, lens), sets)

    def plain(q, kp, vp):
        qg = (q * hd ** -0.5).reshape(b, n_kv, nh // n_kv, hd)
        return ref.paged_attention_ref(qg, kp, vp, tables, lens)

    def library(q, kp, vp):
        k = kp.view(b, mp * bs, n_kv, hd).transpose(1, 2)
        v = vp.view(b, mp * bs, n_kv, hd).transpose(1, 2)
        return _sdpa(q[:, :, None], k, v)

    plain_t = median_ms(plain, sets)
    lib_t = median_ms(library, sets)
    n_tok = int(lens.sum())
    n_bytes = (2 * n_tok * n_kv * hd * 2 + 2 * b * nh * hd * 2
               + tables.numel() * 4 + lens.numel() * 4)
    flops = 2 * 2 * n_tok * (nh // n_kv) * n_kv * hd
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=kernel, plain_ms=plain_t, library_ms=lib_t,
                bound_ms=bound, bound_by=by,
                shape=f"B={b} nh={nh} n_kv={n_kv} hd={hd} len=512 bf16")


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
    kernel = median_ms(lambda q, k, v: ops.flash_prefill(
        q, k, v, block_q=64, block_k=64), sets, iters=20)

    def plain(q, k, v):
        return ref.flash_attention_ref((q * hd ** -0.5).transpose(1, 2),
                                       k.transpose(1, 2), v.transpose(1, 2))

    def library(q, k, v):
        return _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     is_causal=True)

    plain_t = median_ms(plain, sets, iters=10)
    lib_t = median_ms(library, sets, iters=20)
    n_bytes = 2 * (2 * b * s * nh * hd + 2 * b * s * n_kv * hd)
    flops = 2 * 2 * b * nh * hd * s * (s + 1) // 2   # causal pairs
    bound, by = bound_ms(n_bytes, flops, "bfloat16")
    return dict(ms=kernel, plain_ms=plain_t, library_ms=lib_t,
                bound_ms=bound, bound_by=by,
                shape=f"B={b} S={s} nh={nh} n_kv={n_kv} hd={hd} causal bf16")


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


class TokenLog:
    def __init__(self):
        self.tokens = {}

    def on_token(self, aid, rid, tok, t):
        self.tokens.setdefault(aid, []).append(int(tok))


def reduced_engine(torch, pkg):
    """Reduced granite at f32 on the GPU (kernels) and the CPU (plain)."""
    import numpy as np

    cfg = pkg["get_config"]("granite-3-2b").reduced()
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
        log(f"  {sched:9s} gpu={g} cpu_equal={g == c} "
            f"token_match={match:.4f}")
        if g != c:
            raise AssertionError(f"GPU and CPU engines differ: {g} vs {c}")
        if g["swaps"] == 0:
            raise AssertionError("pool 256 did not force a swap")


def full_width(torch, pkg, ops):
    cfg = pkg["get_config"]("granite-3-2b")
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
    agents, budgets = seeded_agents(pkg["EngineAgent"], pkg["InferenceSpec"],
                                    pkg["agent_cost"], 2026, 8, (64, 401),
                                    (16, 65), cfg.vocab)
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
    paged, flash = ops.paged_gqa_decode.launches, ops.flash_prefill.launches
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
    log(f"  launches: paged_gqa_decode={paged} "
        f"(= {cfg.n_layers} x {m['decode_steps']} decode steps: "
        f"{paged == cfg.n_layers * m['decode_steps']}) "
        f"flash_prefill={flash}")
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
    if paged != cfg.n_layers * m["decode_steps"]:
        raise AssertionError("paged decode did not run once per layer and "
                             "decode step")
    if flash <= 0:
        raise AssertionError("flash prefill never launched")
    # one more decode step on the final cache: finite logits of the
    # expected shape
    logits, _ = model.decode(params, eng.cache,
                             eng._d_state[0][:, None].clone(),
                             eng._d_state[1].clone())
    if logits.shape != (8, 1, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError("full-width logits are not finite")
    profile_decode(torch, model, params, eng)
    return {"paged_attention": paged, "flash_attention": flash}


def profile_decode(torch, model, params, eng, steps: int = 4):
    """Where a full-width decode step's time goes: host wall per step, the
    device's busy time (sum of kernel times) and the kernels that take most
    of it, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    toks = eng._d_state[0][:, None].clone()
    pos = eng._d_state[1].clone()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode(params, eng.cache, toks, pos)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / steps * 1e6
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue   # kernels only: operator rows repeat their time
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / steps, ev.count // steps, ev.key))
    busy = sum(r[0] for r in rows)
    log(f"  profile: decode step wall {wall_us:.0f} us (profiler on), "
        f"device busy {busy:.0f} us, idle share "
        f"{1 - busy / wall_us:.3f}" if busy else
        "  profile: the profiler recorded no device time (not measured)")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {dev:9.1f} us/step {count:5d} calls/step  {key[:70]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
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
    ops.kernel_library()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for path in sorted(ops.BUILD_DIR.glob("*.log")):
        for line in path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {path.stem}: {line.strip()}")

    log("== 3. kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"paged_attention": check_paged(ops, ref, torch, gen),
           "flash_attention": check_flash(ops, ref, torch, gen)}
    timing = {"paged_attention": time_paged(ops, ref, torch, gen),
              "flash_attention": time_flash(ops, ref, torch, gen)}
    for name, t in timing.items():
        log(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"(kernel at {t['bound_ms'] / t['ms']:.3%} of the bound)")

    log("== 4. reduced engine, GPU (kernels) against CPU (plain)")
    reduced_engine(torch, pkg)

    log("== 5. full-width granite-3-2b")
    launches = full_width(torch, pkg, ops)

    sources = {
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:125"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:125"),
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
        sys.exit(main())
    except Exception as exc:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
