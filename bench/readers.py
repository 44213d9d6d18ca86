"""The reductions behind the per-layer metrics.  Each metric's file under
``metrics/`` names one of these; each takes the finished ``harness.Run``
and returns the metric's value, or ``None`` where the run holds nothing
to read (the harness then leaves the metric out of the line)."""

from __future__ import annotations

import numpy as np

import roofline


def cost_err(run):
    """Mean |predicted - true| / true agent cost over the window's agents,
    in %: the predictor's error on the costs the scheduler orders by.
    The true cost is the frozen sampler's."""
    rec = run.rec
    aids = run.attempted()
    if not aids:
        return None
    err = [abs(rec.pred[a] - rec.agents[a].true_cost)
           / rec.agents[a].true_cost for a in aids]
    return 100.0 * float(np.mean(err))


def queue_wait_s(run):
    """Mean wall seconds from an inference's submission (its agent's
    submission, or its previous stage's completion) to its admission,
    over the inferences whose wait the profiler's stop did not stall."""
    rec, waits = run.rec, []
    stall = run.tracer.stall if run.tracer is not None else None
    for aid in run.attempted():
        stage_done = rec.stage_done.get(aid, {})
        for rid, (s, _) in rec.inference_of(aid).items():
            sub = rec.submit[aid] if s == 0 else stage_done.get(s - 1)
            if sub is None or rid not in rec.admit:
                continue
            if stall and sub < stall[1] and rec.admit[rid] > stall[0]:
                continue
            waits.append(rec.admit[rid] - sub)
    return float(np.mean(waits)) if waits else None


def swaps_per_agent(run):
    """The engine's swap counter (swap-ins) over the agents completed."""
    done = sum(a in run.rec.done for a in run.attempted())
    if not done:
        return None
    return run.engine.metrics["swaps"] / done


def decode_step_ms(run):
    """Wall ms per decode step of the ``engine.decode_window`` spans
    outside the profiled seconds: the window's launches, its one copy to
    the host and the host's replay of its tokens, over the steps run."""
    tr = run.tracer
    lo, hi = tr.traced if tr.traced else (None, None)
    wall, steps = 0.0, 0
    for name, t0, t1, n, *_ in tr.spans:
        if name != "engine.decode_window" or not n:
            continue
        if lo is not None and hi is not None and t1 > lo and t0 < hi:
            continue
        wall += t1 - t0
        steps += n
    return 1e3 * wall / steps if steps else None


def mfu(run):
    """FLOPs of the useful prefill and decode tokens the traced window
    launched, over its seconds at the bf16 peak, in %."""
    tr = run.tracer
    if not tr.device:
        return None
    flops = tr.useful_flops(run.family, run.cfg)
    if not flops:
        return None
    return 100.0 * flops / (tr.device["window_s"] * roofline.PEAK_FLOPS_BF16)


def roofline_share(run, kind: str):
    """The sum of the traced calls' least times over the kernel's device
    time in the trace, in %; nothing where the trace holds no call, or
    where the kernels in the trace and the calls recorded do not pair."""
    tr = run.tracer
    if not tr.device:
        return None
    bounds = tr.paged_bounds() if kind == "paged" else tr.flash_bounds()
    if not bounds or tr.n_kernels[kind] != len(bounds):
        return None
    return 100.0 * sum(bounds) / tr.kernel_time(kind)


def idle_share(run):
    """Share of the traced window in which no operation ran on the
    device, in %."""
    dev = run.tracer.device
    if not dev or not dev["window_s"]:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
