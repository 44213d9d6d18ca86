"""Tracing of a ``--trace 1`` run: spans around the program's layers, the
kernel calls' shapes and lengths, and a ``torch.profiler`` trace of a
steady few seconds of the window.

Spans are the benchmark's own, put around the program from outside:

* ``engine.step`` (one admission pass and one decode window), and inside
  it ``engine.admit`` (``ServeEngine._admit``), ``engine.prefill``
  (``_prefill_batch``), ``engine.decode_window`` (``_decode_once``: token
  growth, swaps, the window's launches, its one device-to-host copy and
  the host's replay of its tokens) and ``engine.decode_launch`` (the
  module's ``_decode_window``: the launches alone);
* ``harness.submit`` (the predictor's call and the submission) and
  ``harness.wait`` (idle until the next agent is due).

Each span is stamped on the host's monotonic clock, for the spans'
own walls, and on the wall clock in nanoseconds since the epoch, the time
base in which the profiler reports the device's operations, so that an
idle gap on the device can be put beside the span the host was in.  On
the card an engine span ends with a synchronise.  The profiler records
the device's activity only: recording every host operation as well made
stopping it take seconds inside the window.  The kernel wrappers
(``paged_gqa_decode`` and ``flash_prefill`` as the model calls them)
record each call's shapes and its lengths tensor, without a span or a
synchronise: a synchronise per layer would serialise the host and the
device and change what is measured, and the kernels' own times come from
the device trace.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Optional

import torch

import roofline

#: names of the kernels whose roofline share is read, by call kind
KERNEL_NAMES = {"paged": ("paged_split_kernel",),
                "flash": ("flash_tc_kernel", "flash_prefill_kernel")}
#: longest kernel name kept in the breakdown
NAME_CHARS = 160


class Tracer:
    def __init__(self, run):
        self.run = run
        self.cuda = run.device.type == "cuda"
        #: (name, start, end, decode steps, start ns, end ns)
        self.spans: list[tuple] = []
        self.patches: list[tuple[object, str, object]] = []
        self.prof = None
        self.active = False
        self.window = None                  # (start, length) planned
        self.traced: Optional[tuple[float, float]] = None  # host clock
        self.paged: list[tuple] = []
        self.flash: list[tuple] = []
        self.prefills: list[tuple] = []
        self.decodes: list[tuple] = []
        self._pass = None
        self.breakdown: dict = {}
        self.device: dict = {}
        self.stop_s = 0.0
        #: host-clock interval in which stopping the profiler stalled
        #: serving (inside the window, between two steps)
        self.stall: Optional[tuple[float, float]] = None
        self.aligned = 0.0

    # ------------------------------------------------------------ spans

    @contextlib.contextmanager
    def span(self, name: str, steps=None):
        """A span; ``steps``, where given, reads the engine's decode-step
        counter, and the span records how many steps it ran."""
        before = steps() if steps else 0
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            if self.cuda and name.startswith("engine."):
                torch.cuda.synchronize()
            n = steps() - before if steps else 0
            self.spans.append((name, t0, time.perf_counter(), n, w0,
                               time.time_ns()))

    def _patch(self, obj, attr: str, new) -> None:
        self.patches.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    def _wrap(self, obj, attr: str, name: str, steps=None) -> None:
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with self.span(name, steps):
                return inner(*args, **kwargs)

        self._patch(obj, attr, wrapped)

    def install(self) -> None:
        from repro_torch.engine import engine as engine_mod
        from repro_torch.models import transformer

        eng = self.run.engine

        def steps():
            return eng.metrics["decode_steps"]

        self._wrap(eng, "_admit", "engine.admit")
        self._wrap(eng, "_prefill_batch", "engine.prefill")
        self._wrap(eng, "_decode_once", "engine.decode_window", steps)

        launch = engine_mod._decode_window

        def decode_window(model, k, params, cache, state):
            if self.active:
                self.decodes.append((int(k), state))
            with self.span("engine.decode_launch"):
                return launch(model, k, params, cache, state)

        self._patch(engine_mod, "_decode_window", decode_window)

        write = engine_mod._prefill_write

        def prefill_write(model, cache_len, chunk, params, cache, tokens,
                          lens, slots):
            n_slots = next(iter(cache.values())).shape[1]
            self._pass = (lens, [int(s) for s in slots], n_slots,
                          int(tokens.shape[1]))
            if self.active:
                self.prefills.append(self._pass)
            return write(model, cache_len, chunk, params, cache, tokens,
                         lens, slots)

        self._patch(engine_mod, "_prefill_write", prefill_write)

        paged = transformer.paged_gqa_decode

        def paged_gqa_decode(q, k_pages, v_pages, block_tables, lengths,
                             **kw):
            if self.active:
                self.paged.append((tuple(q.shape), tuple(k_pages.shape),
                                   int(block_tables.shape[1]), lengths))
            return paged(q, k_pages, v_pages, block_tables, lengths, **kw)

        self._patch(transformer, "paged_gqa_decode", paged_gqa_decode)

        flash = transformer.flash_prefill

        def flash_prefill(q, k, v, **kw):
            if self.active:
                self.flash.append((tuple(q.shape), tuple(k.shape),
                                   int(kw.get("window", 0)), self._pass))
            return flash(q, k, v, **kw)

        self._patch(transformer, "flash_prefill", flash_prefill)

    def uninstall(self) -> None:
        while self.patches:
            obj, attr, old = self.patches.pop()
            setattr(obj, attr, old)

    # ------------------------------------------------------------ profiler

    def plan(self, start: float, seconds: float) -> None:
        self.window = (start, seconds)

    def tick(self) -> None:
        """Between two engine steps: start the profiler once the planned
        start has passed, stop it once the planned seconds have."""
        if self.window is None:
            return
        start, seconds = self.window
        now = time.perf_counter()
        if self.prof is None and now >= start:
            self._start()
        elif self.active and now >= self.traced[0] + seconds:
            self.stop()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        if self.cuda:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        else:
            self.prof = False         # nothing to trace on the CPU
        self.active = True
        self.traced = (time.perf_counter(), None)
        self.traced_ns = (time.time_ns(), None)

    def stop(self) -> None:
        if not self.active:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.traced = (self.traced[0], time.perf_counter())
        self.traced_ns = (self.traced_ns[0], time.time_ns())
        self.active = False
        if self.prof:
            t = time.perf_counter()
            self.prof.stop()
            self.stall = (t, time.perf_counter())
            self.stop_s = self.stall[1] - t

    # ------------------------------------------------------------ reading

    def read(self) -> None:
        """Reduce the trace: device busy and idle time over the traced
        window, each kernel's time by name, the idle gaps by the host span
        open during them, and the kernel calls' bounds."""
        if not self.prof or self.traced[1] is None:
            return
        w0, w1 = self.traced_ns
        kernels = []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if not str(e.device_type()).endswith("CUDA") or name.startswith(
                    ("engine.", "harness.")):
                continue
            s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if t > s:
                kernels.append((s, t, name))
        host = [(a, b, name) for name, _, _, _, a, b in self.spans
                if b > w0 and a < w1]
        busy = _union([(s, t) for s, t, _ in kernels])
        busy_ns = sum(t - s for s, t in busy)
        self.device = {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9}
        by_name: dict[str, float] = {}
        for s, t, name in kernels:
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
        self.kernel_s = by_name
        gaps = _gaps(busy, w0, w1)
        idle = _attribute(gaps, host)
        steps = _union([(a, b) for a, b, n in host if n == "engine.step"])
        #: share of the device's busy time that falls inside the host's
        #: engine steps: near 1 where the two clocks agree
        self.aligned = (sum(_overlap(busy, steps)) / busy_ns
                        if busy_ns else 0.0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        self.breakdown = {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        }
        self.n_kernels = {kind: sum(1 for _, _, n in kernels
                                    if any(k in n for k in names))
                          for kind, names in KERNEL_NAMES.items()}

    def kernel_time(self, kind: str) -> float:
        names = KERNEL_NAMES[kind]
        return sum(s for n, s in self.kernel_s.items()
                   if any(k in n for k in names))

    def paged_bounds(self) -> list[float]:
        """The least time of each traced paged-decode call, from the
        lengths it was given."""
        lens = _host(t for *_, t in self.paged)
        out = []
        for (b, nh, hd), (_, _, n_kv, _), max_pages, t in self.paged:
            n_bytes, flops = roofline.paged_call(lens[id(t)], nh, n_kv, hd,
                                                 max_pages)
            out.append(roofline.bound_s(n_bytes, flops))
        return out

    def flash_bounds(self) -> list[float]:
        """The least time of each traced flash call, over the real rows of
        its prefill pass at their real lengths."""
        lens = _host(p[0] for *_, p in self.flash)
        out = []
        for (_, _, nh, hd), (_, _, n_kv, _), window, p in self.flash:
            real = [n for n, s in zip(lens[id(p[0])], p[1])
                    if 0 <= s < p[2]]
            n_bytes, flops = roofline.flash_call(real, nh, n_kv, hd, window)
            out.append(roofline.bound_s(n_bytes, flops))
        return out

    def useful_flops(self, family, cfg: dict) -> float:
        """FLOPs of the useful prefill and decode tokens the traced window
        launched: every real prompt row of its prefill passes, and every
        live slot's token of its decode steps (padding rows, padded
        buckets, frozen and free slots left out)."""
        total = 0.0
        lens = _host(p[0] for p in self.prefills)
        for lens_t, slots, n_slots, _ in self.prefills:
            for n, s in zip(lens[id(lens_t)], slots):
                if 0 <= s < n_slots:
                    total += family.prefill_flops(cfg, n)
        states = _host(st for _, st in self.decodes)
        for k, st in self.decodes:
            _, pos, rem = states[id(st)]
            for i in range(k):
                for p, r in zip(pos, rem):
                    if r > i:
                        total += family.decode_flops(cfg, p + i + 1)
        return total


def _host(tensors) -> dict:
    """id -> host list of each distinct tensor."""
    out = {}
    for t in tensors:
        if id(t) not in out:
            out[id(t)] = t.cpu().tolist()
    return out


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def _overlap(a, b) -> list[int]:
    """Lengths of the overlaps of two sorted disjoint interval lists."""
    out, j = [], 0
    for s, t in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t:
            out.append(min(t, b[k][1]) - max(s, b[k][0]))
            k += 1
    return out


def _gaps(busy, w0: int, w1: int) -> list[tuple[int, int]]:
    gaps, cur = [], w0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def _segments(host) -> list[tuple[int, int, str]]:
    """The host's timeline cut into pieces, each labelled by the innermost
    span open over it (``harness.other`` where none is)."""
    edges = sorted({x for s, t, _ in host for x in (s, t)})
    if not edges:
        return []
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out = []
    for a, b in zip(edges, edges[1:]):
        inner = None
        for s, t, name in host:
            if s > a:
                break
            if t >= b:
                inner = name
        out.append((a, b, inner or "harness.other"))
    return out


def _attribute(gaps, host) -> dict[str, float]:
    """Idle seconds by the innermost host span open during them."""
    segs = _segments(host)
    starts = [s for s, _, _ in segs]
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        cur = g0
        while cur < g1:
            if i >= len(segs) or segs[i][0] > cur:
                nxt = segs[i][0] if i < len(segs) else g1
                end = min(g1, nxt)
                idle["harness.other"] = (idle.get("harness.other", 0.0)
                                         + (end - cur) / 1e9)
                cur = end
                continue
            s, t, name = segs[i]
            end = min(g1, t)
            if end > cur:
                idle[name] = idle.get(name, 0.0) + (end - cur) / 1e9
            cur = max(cur, end)
            i += 1
    return idle
