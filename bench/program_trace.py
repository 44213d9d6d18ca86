"""The reductions behind the per-layer metrics that read the program's own
records: the spans that ``ServeEngine`` keeps in its ``trace``
(``repro_torch.trace``), stamped on ``time.perf_counter_ns()``, the clock
of the harness's own stamps (``Run.t0``, ``Tracer.traced``,
``Tracer.stall``, in seconds).

Each function takes the finished ``harness.Run`` and returns the metric's
value, or ``None`` where there is nothing to read, as where the engine
keeps no records (a program older than them).  It reads the ``step``
spans that lie between ``Run.t0`` and ``Run.drain_end``, outside the
profiled seconds and outside the profiler's stall, and the spans under
them.  The harness reads per-layer metrics in the ``--trace 1`` run
alone, and for that whole run ``spans.py`` synchronises after every
``engine.*`` span: these are the program's steps as the traced run slows
them, with the profiler and its stop left out but not the synchronises.

The spans' names and attributes (``repro_torch/trace.py``):

* ``step``; under it one ``prefill`` per pass (``padded``: its rows after
  the power-of-two pad, ``bucket``, ``lens``: the real prompt lengths)
  and ``decode`` (``k`` steps, ``tokens`` decoded, ``keys`` attended,
  summed over the tokens), and under that ``decode.replay`` (the host's
  per-token replay).
"""

from __future__ import annotations

from typing import Optional

import roofline


def recorder(run):
    """The engine's recorder, or None where the program keeps none."""
    return getattr(getattr(run, "engine", None), "trace", None)


def _ns(seconds: float) -> int:
    return int(round(seconds * 1e9))


def _excluded(run) -> list[tuple[int, int]]:
    """The profiled seconds and the profiler's stall, in perf_counter ns."""
    tr = run.tracer
    out = []
    if tr is not None:
        for iv in (tr.traced, tr.stall):
            if iv and iv[1] is not None:
                out.append((_ns(iv[0]), _ns(iv[1])))
    return out


def window_spans(run) -> Optional[list]:
    """The selected ``step`` spans and every span under them, in the
    order they opened; None where the program keeps no records."""
    rec = recorder(run)
    if rec is None:
        return None
    lo, hi = _ns(run.t0), _ns(run.drain_end)
    cut = _excluded(run)
    keep, out = set(), []
    for s in sorted(rec.spans, key=lambda s: s.id):
        if s.name == "step":
            inside = lo <= s.start and s.end <= hi and not any(
                s.start < b and a < s.end for a, b in cut)
            if not inside:
                continue
        elif s.parent not in keep:
            continue
        keep.add(s.id)
        out.append(s)
    return out


def _named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def replay_ms(run):
    """Host ms inside ``decode.replay`` per decode step: the per-token
    bookkeeping after each window's copy to the host."""
    spans = window_spans(run)
    if spans is None:
        return None
    steps = sum(s.attrs["k"] for s in _named(spans, "decode"))
    if not steps:
        return None
    wall = sum(s.end - s.start for s in _named(spans, "decode.replay"))
    return wall / 1e6 / steps


def prefill_pad_share(run):
    """1 - real prompt tokens / (padded rows x bucket) over the prefill
    passes, in %: the share of a pass's rows that is padding."""
    spans = window_spans(run)
    if spans is None:
        return None
    passes = _named(spans, "prefill")
    run_tokens = sum(s.attrs["padded"] * s.attrs["bucket"] for s in passes)
    if not run_tokens:
        return None
    real = sum(sum(s.attrs["lens"]) for s in passes)
    return 100.0 * (1.0 - real / run_tokens)


def useful_flops(run, spans) -> float:
    """FLOPs of the real prompt tokens of the ``prefill`` spans and of the
    tokens of the ``decode`` spans.  A decode token's FLOPs are linear in
    the keys it attends, so the spans' sums give them exactly.  A fused
    prefill (``fused_prefill``) runs inside the decode windows, opens no
    ``prefill`` span and is not counted."""
    fam, cfg = run.family, run.cfg
    total = sum(fam.prefill_flops(cfg, n)
                for s in _named(spans, "prefill") for n in s.attrs["lens"])
    base = fam.decode_flops(cfg, 0)
    per_key = fam.decode_flops(cfg, 1) - base
    for s in _named(spans, "decode"):
        total += s.attrs["tokens"] * base + s.attrs["keys"] * per_key
    return total


def step_mfu(run):
    """Useful FLOPs of the selected steps over their wall at the bf16
    peak, in %; nothing off the card.  It needs no profiler, and no call
    of the kernel wrappers."""
    if run.device.type != "cuda":
        return None
    spans = window_spans(run)
    if not spans:
        return None
    wall = sum(s.end - s.start for s in _named(spans, "step")) / 1e9
    flops = useful_flops(run, spans)
    if not wall or not flops:
        return None
    return 100.0 * flops / (wall * roofline.PEAK_FLOPS_BF16)
