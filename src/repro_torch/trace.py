"""Spans recorded inside the serving engine.

``ServeEngine`` owns one ``Recorder`` and records, at its layer
boundaries, the spans ``step`` (one ``ServeEngine.step``) and, inside it,
``prefill`` (one per prefill group), ``decode`` (token growth to the end
of the host's replay) and, inside that, ``decode.replay`` (the host's
per-token replay).  Each span has a name, a start and an end, the id of
the span that caused it and a few integer attributes.  Every stamp is
``time.perf_counter_ns()``, the host's monotonic clock.

A span opened by ``Recorder.child`` takes the recorder's open span as its
parent; with no span open it records nothing, so a call outside an engine
step leaves no span.  The recorder never synchronises with the device,
uses no profiler, and keeps at most ``CAPACITY`` spans in memory, dropping
the oldest first.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

#: spans a recorder keeps.  A benchmark run (a window of 51 s, a drain of
#: as long again and the profiler's stall) steps the engine at most a few
#: thousand times at three or four spans a step, so none drop; at the cap
#: the buffer holds some tens of MB.
CAPACITY = 1 << 17


class Span:
    """One timed interval.  ``attrs`` may be filled in while it is open.
    A span with no recorder times nothing that is kept."""

    __slots__ = ("id", "name", "start", "end", "parent", "attrs",
                 "recorder", "_outer")

    def __init__(self, recorder: Optional["Recorder"], name: str,
                 parent: int, attrs: dict):
        self.recorder = recorder
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self.id = -1
        self.start = self.end = 0

    def __enter__(self) -> "Span":
        rec = self.recorder
        if rec is not None:
            self.id = rec._next_id
            rec._next_id += 1
            self._outer, rec.open = rec.open, self
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        rec = self.recorder
        if rec is not None:
            rec.open, self._outer = self._outer, None
            rec.spans.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.end - self.start} ns, {self.attrs})")


class Recorder:
    """The spans of one engine, in a bounded buffer."""

    def __init__(self):
        #: closed spans, in the order they closed
        self.spans: collections.deque[Span] = collections.deque(
            maxlen=CAPACITY)
        #: the innermost span open now, or None
        self.open: Optional[Span] = None
        self._next_id = 0

    def span(self, name: str, **attrs) -> Span:
        """A span of this recorder, child of its open span (or a root)."""
        cur = self.open
        return Span(self, name, -1 if cur is None else cur.id, attrs)

    def child(self, name: str, **attrs) -> Span:
        """A span under the open span; with none open, a span that records
        nothing."""
        cur = self.open
        if cur is None:
            return Span(None, name, -1, attrs)
        return Span(self, name, cur.id, attrs)
