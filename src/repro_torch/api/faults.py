"""Deterministic fault-injection plans for replicated fleets (PR 8).

A :class:`FaultPlan` is a seeded, immutable-once-built schedule of
replica-level faults — ``crash`` / ``stall`` / ``slowdown`` — that
:class:`repro.api.ReplicatedBackend` injects at ``advance()`` boundaries.
Faults are expressed purely in workload time and evaluated by clamping
each child's advancement horizon, never by mutating child state, so the
same plan on the same workload reproduces the same run bit for bit:

  * ``crash(replica, at)`` — the child stops advancing at ``at`` forever.
    Its queued/in-flight agents are failed over once the fleet watchdog
    declares it DEAD.
  * ``stall(replica, at, duration)`` — the child makes no progress inside
    ``[at, at + duration)`` and resumes afterwards.  Because both backends
    derive event timestamps from their own clocks (not from how often they
    are advanced), a stall shorter than the watchdog budget is invisible
    in the final results — it exercises the suspect/recover path only.
  * ``slowdown(replica, at, duration, factor)`` — inside the window the
    child advances at ``factor`` times real time (``0 < factor < 1``).

Windows on the same replica must not overlap, and nothing may be
scheduled after a crash on that replica.  ``FaultPlan.seeded`` builds a
reproducible random plan from an integer seed — the benchmark/chaos-demo
entry point.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["Fault", "FaultPlan"]

_KINDS = ("crash", "stall", "slowdown")


@dataclass(frozen=True)
class Fault:
    """One scheduled fault window on one replica.

    ``start`` is inclusive; ``duration`` is ``inf`` for crashes.  For
    ``slowdown``, ``factor`` is the fraction of real-time progress the
    replica makes inside the window.
    """

    replica: int
    kind: str
    start: float
    duration: float = math.inf
    factor: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.replica < 0:
            raise ValueError(f"negative replica index {self.replica}")
        if self.start < 0.0:
            raise ValueError(f"fault start {self.start} < 0")
        if self.duration <= 0.0:
            raise ValueError(f"fault duration {self.duration} <= 0")
        if self.kind == "crash" and not math.isinf(self.duration):
            raise ValueError("crash faults are permanent (duration=inf)")
        if self.kind == "stall" and math.isinf(self.duration):
            raise ValueError("stall needs a finite duration")
        if self.kind == "slowdown":
            if math.isinf(self.duration):
                raise ValueError("slowdown needs a finite duration")
            if not (0.0 < self.factor < 1.0):
                raise ValueError(
                    f"slowdown factor must be in (0, 1), got {self.factor}"
                )

    @property
    def end(self) -> float:
        return self.start + self.duration


@dataclass
class FaultPlan:
    """A deterministic per-replica fault schedule.

    Build with the ``crash`` / ``stall`` / ``slowdown`` methods (each
    returns ``self`` for chaining) or :meth:`seeded`; the plan validates
    itself on every addition.  Consumers only read — via
    :meth:`faults_for`, :meth:`crash_time`, :meth:`boundaries`, and
    :meth:`horizon` — so a plan can be reused across runs.
    """

    faults: list = field(default_factory=list)

    # ------------------------------------------------------------ builders
    def add(self, fault: Fault) -> "FaultPlan":
        for other in self.faults:
            if other.replica != fault.replica:
                continue
            if other.kind == "crash" and fault.start >= other.start:
                raise ValueError(
                    f"replica {fault.replica} crashes at {other.start}; "
                    f"cannot schedule {fault.kind} at {fault.start} after it"
                )
            if fault.kind == "crash" and other.start >= fault.start:
                raise ValueError(
                    f"crash at {fault.start} precedes existing "
                    f"{other.kind} at {other.start} on replica "
                    f"{fault.replica}"
                )
            if (fault.start < other.end and other.start < fault.end):
                raise ValueError(
                    f"overlapping fault windows on replica "
                    f"{fault.replica}: [{other.start}, {other.end}) and "
                    f"[{fault.start}, {fault.end})"
                )
        self.faults.append(fault)
        self.faults.sort(key=lambda f: (f.replica, f.start))
        return self

    def crash(self, replica: int, at: float) -> "FaultPlan":
        return self.add(Fault(replica, "crash", at))

    def stall(self, replica: int, at: float,
              duration: float) -> "FaultPlan":
        return self.add(Fault(replica, "stall", at, duration))

    def slowdown(self, replica: int, at: float, duration: float,
                 factor: float) -> "FaultPlan":
        return self.add(Fault(replica, "slowdown", at, duration, factor))

    @classmethod
    def seeded(cls, seed: int, n_replicas: int, *,
               n_crashes: int = 1, crash_window=(5.0, 20.0),
               n_stalls: int = 0, stall_duration=(1.0, 4.0)) -> "FaultPlan":
        """A reproducible random plan: ``n_crashes`` distinct replicas
        crash at times drawn from ``crash_window``; ``n_stalls`` distinct
        OTHER replicas stall once each."""
        import numpy as np

        if n_crashes + n_stalls > n_replicas:
            raise ValueError(
                f"{n_crashes} crashes + {n_stalls} stalls exceed "
                f"{n_replicas} replicas"
            )
        rng = np.random.default_rng(seed)
        victims = rng.permutation(n_replicas)
        plan = cls()
        lo, hi = crash_window
        for k in victims[:n_crashes]:
            plan.crash(int(k), float(rng.uniform(lo, hi)))
        dlo, dhi = stall_duration
        for k in victims[n_crashes:n_crashes + n_stalls]:
            plan.stall(int(k), float(rng.uniform(lo, hi)),
                       float(rng.uniform(dlo, dhi)))
        return plan

    # ------------------------------------------------------------- queries
    def faults_for(self, replica: int) -> list:
        return [f for f in self.faults if f.replica == replica]

    def crash_time(self, replica: int) -> float:
        """Crash time for ``replica``, or ``inf`` if it never crashes."""
        for f in self.faults:
            if f.replica == replica and f.kind == "crash":
                return f.start
        return math.inf

    def boundaries(self) -> list:
        """Every finite window edge, sorted — the fleet drive loop slices
        its advancement at these points so fault onsets/offsets land
        exactly where the plan says."""
        ts = set()
        for f in self.faults:
            ts.add(f.start)
            if not math.isinf(f.end):
                ts.add(f.end)
        return sorted(ts)

    def horizon(self, replica: int, target: float) -> float:
        """The furthest workload time ``replica`` may advance to when the
        fleet drives toward ``target``.

        Crash clamps at the crash time forever; a stall window clamps at
        its start until the window closes; a slowdown window maps fleet
        progress into the window at ``factor`` speed.  Outside any window
        the replica is unconstrained (returns ``target``).
        """
        h = target
        for f in self.faults_for(replica):
            if f.kind == "crash":
                h = min(h, f.start)
            elif f.kind == "stall":
                if target < f.end:
                    h = min(h, f.start)
            elif f.kind == "slowdown":
                if f.start < target < f.end:
                    h = min(h, f.start + f.factor * (target - f.start))
        return h

    def max_boundary(self) -> float:
        """Latest finite edge in the plan (0.0 for an empty plan) — the
        fleet drains past this plus the watchdog budget so every planned
        fault has been observed before results are collected."""
        finite = [t for t in self.boundaries() if not math.isinf(t)]
        return max(finite) if finite else 0.0
