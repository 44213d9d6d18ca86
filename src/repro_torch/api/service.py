"""``AgentService`` — the single serving facade over every backend.

This is how launchers, examples, benchmarks, and tests drive serving::

    service = AgentService.sim(scheduler="justitia", total_kv=16384.0)
    # or: AgentService.engine(model, params, scheduler="justitia", ...)
    for spec in workload:                      # AgentSpec, arrival in seconds
        handle = service.submit(spec)          # online: at any time
    service.run(until=30.0)                    # interleave with more submits
    result = service.drain()                   # ServiceResult

Each submission returns an :class:`AgentHandle` that streams the agent's
lifecycle (admission, swaps, per-stage completions, per-token events on the
engine backend) and accepts :class:`repro.api.events.AgentHooks` callbacks.
A :class:`MetricsRecorder` built on ``repro.sim.metrics`` aggregates JCT
statistics and event counts uniformly across backends.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from repro_torch.api.backend import AgentSpec, Backend, BackendResult
from repro_torch.api.events import (
    AdmissionDeferred,
    AgentArrived,
    AgentCompleted,
    AgentEvent,
    AgentHooks,
    AgentRequeued,
    AgentResumed,
    AgentSuspended,
    PrefixHit,
    ReplicaFailed,
    ReplicaRecovered,
    RequestAdmitted,
    RequestSwappedIn,
    RequestSwappedOut,
    StageCompleted,
    StageOutcome,
    TokenGenerated,
)
from repro_torch.sim.metrics import (
    JctStats,
    LatencyStats,
    SloStats,
    SloTier,
    fair_ratios,
    fairness_stats,
    jct_stats,
    latency_stats,
    slo_attainment,
)


@dataclasses.dataclass
class AgentHandle:
    """Live view of one submitted agent's session."""

    agent_id: int
    spec: AgentSpec
    arrival: float                      # effective arrival, workload seconds
    hooks: AgentHooks
    status: str = "pending"             # pending -> active -> done
    record_events: bool = True          # retain events/tokens on the handle
    replica: Optional[int] = None       # serving replica (replicated fleets)
    finish: Optional[float] = None
    jct: Optional[float] = None
    stage_finish: dict[int, float] = dataclasses.field(default_factory=dict)
    tokens: list[int] = dataclasses.field(default_factory=list)
    events: list[AgentEvent] = dataclasses.field(default_factory=list)
    #: tokens observed in total / at the last stage boundary — maintained
    #: even with ``record_events=False`` (closed-loop callbacks read the
    #: per-stage difference via ``StageOutcome.new_tokens``)
    token_count: int = 0
    _stage_token_mark: int = 0

    @property
    def done(self) -> bool:
        return self.status == "done"

    def _record(self, ev: AgentEvent) -> None:
        if self.record_events:
            self.events.append(ev)
        if ev.replica is not None:
            self.replica = ev.replica
        if isinstance(ev, AgentArrived):
            self.status = "active"
            self.arrival = ev.time
        elif isinstance(ev, RequestAdmitted):
            if self.hooks.on_admit:
                self.hooks.on_admit(ev)
        elif isinstance(ev, (RequestSwappedOut, RequestSwappedIn)):
            if self.hooks.on_swap:
                self.hooks.on_swap(ev)
        elif isinstance(ev, PrefixHit):
            if self.hooks.on_prefix_hit:
                self.hooks.on_prefix_hit(ev)
        elif isinstance(ev, AgentRequeued):
            if self.hooks.on_requeued:
                self.hooks.on_requeued(ev)
        elif isinstance(ev, AgentSuspended):
            if self.hooks.on_suspend:
                self.hooks.on_suspend(ev)
        elif isinstance(ev, AgentResumed):
            if self.hooks.on_resume:
                self.hooks.on_resume(ev)
        elif isinstance(ev, AdmissionDeferred):
            if self.hooks.on_defer:
                self.hooks.on_defer(ev)
        elif isinstance(ev, TokenGenerated):
            self.token_count += 1
            if self.record_events:
                self.tokens.append(ev.token)
            if self.hooks.on_token:
                self.hooks.on_token(ev)
        elif isinstance(ev, StageCompleted):
            self.stage_finish[ev.stage] = ev.time
            if self.hooks.on_stage_complete:
                self.hooks.on_stage_complete(ev)
        elif isinstance(ev, AgentCompleted):
            self.status = "done"
            self.finish = ev.time
            self.jct = ev.jct
            if self.hooks.on_complete:
                self.hooks.on_complete(ev)


class MetricsRecorder:
    """Uniform serving metrics across backends (on ``repro.sim.metrics``).

    Events served through a replicated fleet carry a ``replica`` index;
    the recorder aggregates both fleet-level JCTs (``jct``/``jct_stats``)
    and per-replica JCTs (``replica_jct``/``per_replica_jct_stats``) from
    the same stream.
    """

    def __init__(self) -> None:
        self.jct: dict[int, float] = {}
        self.finish: dict[int, float] = {}
        self.event_counts: dict[str, int] = {}
        self.replica_jct: dict[int, dict[int, float]] = {}
        # latency accounting (PR 7), fed by the streamed token events —
        # both backends stamp them in workload seconds, so TTFT/TBT fall
        # out of the same stream on either
        self.arrival: dict[int, float] = {}
        self.first_token: dict[int, float] = {}       # agent -> time
        self.last_token: dict[int, float] = {}
        #: per-request token spans, keyed (replica, rid) — rids are only
        #: unique per child backend in a replicated fleet
        self._req_first: dict = {}
        self._req_last: dict = {}
        self._req_count: dict = {}
        self._req_agent: dict = {}

    def record(self, ev: AgentEvent) -> None:
        kind = type(ev).__name__
        self.event_counts[kind] = self.event_counts.get(kind, 0) + 1
        if isinstance(ev, AgentArrived):
            self.arrival[ev.agent_id] = ev.time
        elif isinstance(ev, TokenGenerated):
            aid = ev.agent_id
            self.first_token.setdefault(aid, ev.time)
            self.last_token[aid] = ev.time
            key = (ev.replica, ev.rid)
            self._req_first.setdefault(key, ev.time)
            self._req_last[key] = ev.time
            self._req_count[key] = self._req_count.get(key, 0) + 1
            self._req_agent[key] = aid
        elif isinstance(ev, AgentCompleted):
            self.jct[ev.agent_id] = ev.jct
            self.finish[ev.agent_id] = ev.time
            if ev.replica is not None:
                self.replica_jct.setdefault(ev.replica, {})[
                    ev.agent_id
                ] = ev.jct

    def ttfts(self) -> dict[int, float]:
        """Per-agent TTFT: arrival -> first streamed token (any request).

        Queueing-inclusive — the latency the agent's user experiences,
        which is where admission-stall interference shows up.  Empty
        without token streaming.
        """
        return {
            aid: t - self.arrival.get(aid, 0.0)
            for aid, t in self.first_token.items()
        }

    def tbts(self) -> dict[int, float]:
        """Per-agent mean time-between-tokens, pooled over the agent's
        requests (``sum(span) / sum(tokens - 1)``): cross-stage queueing
        and prefill gaps are excluded, so this is pure decode cadence.
        Agents whose requests all decoded a single token have no sample.
        """
        span: dict[int, float] = {}
        gaps: dict[int, int] = {}
        for key, n in self._req_count.items():
            if n < 2:
                continue
            aid = self._req_agent[key]
            span[aid] = span.get(aid, 0.0) + (
                self._req_last[key] - self._req_first[key]
            )
            gaps[aid] = gaps.get(aid, 0) + (n - 1)
        return {aid: span[aid] / gaps[aid] for aid in span}

    def latency_stats(self) -> LatencyStats:
        return latency_stats(self.ttfts(), self.tbts())

    def slo_stats(self, tiers: "dict[int, SloTier]") -> SloStats:
        """SLO attainment for the given agent -> tier assignment."""
        return slo_attainment(self.ttfts(), self.tbts(), tiers)

    def jct_stats(self) -> JctStats:
        return jct_stats(self.jct)

    def per_replica_jct_stats(self) -> dict[int, JctStats]:
        """Per-replica JCT aggregates (empty for unreplicated backends)."""
        return {
            r: jct_stats(jcts)
            for r, jcts in sorted(self.replica_jct.items())
        }

    def fairness_vs(self, reference_jct: dict[int, float]):
        """Finish-time fair ratios against a reference run (paper §5.1)."""
        return fairness_stats(fair_ratios(self.jct, reference_jct))


@dataclasses.dataclass
class ServiceResult:
    """What ``drain`` returns: per-agent outcomes + aggregate stats."""

    finish: dict[int, float]
    jct: dict[int, float]
    stats: JctStats
    makespan: float
    swaps: int
    sched_decisions: int
    sched_time: float
    backend: str
    metrics: dict
    event_counts: dict
    #: replica -> JctStats when served by a replicated fleet (else empty)
    per_replica: dict = dataclasses.field(default_factory=dict)
    #: TTFT/TBT percentiles from the streamed token events (all-zero
    #: unless the service streamed tokens — engine default, sim
    #: ``token_events=True``)
    latency: Optional[LatencyStats] = None


class _Dispatcher:
    """Translates backend-native callbacks into typed workload-time events.

    A :class:`repro.api.ReplicatedBackend` forwards its children's callbacks
    with a ``replica=k`` keyword (and pre-converted workload timestamps, so
    its ``to_workload_time`` is the identity); unreplicated backends omit it.
    """

    def __init__(self, service: "AgentService") -> None:
        self.svc = service

    def _push(self, agent_id: int, ev: AgentEvent) -> None:
        self.svc.recorder.record(ev)
        handle = self.svc.handles.get(agent_id)
        if handle is not None:
            handle._record(ev)

    def _t(self, t: float) -> float:
        return self.svc.backend.to_workload_time(t)

    def on_arrival(
        self, agent_id: int, t: float, *, replica: Optional[int] = None
    ) -> None:
        self._push(agent_id, AgentArrived(agent_id, self._t(t),
                                          replica=replica))

    def on_admit(
        self, agent_id: int, rid: int, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        self._push(agent_id, RequestAdmitted(agent_id, self._t(t), rid,
                                             replica=replica))

    def on_swap_out(
        self, agent_id: int, rid: int, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        self._push(agent_id, RequestSwappedOut(agent_id, self._t(t), rid,
                                               replica=replica))

    def on_swap_in(
        self, agent_id: int, rid: int, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        self._push(agent_id, RequestSwappedIn(agent_id, self._t(t), rid,
                                              replica=replica))

    def on_token(
        self, agent_id: int, rid: int, token: int, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        self._push(agent_id, TokenGenerated(agent_id, self._t(t), rid, token,
                                            replica=replica))

    def on_prefix_hit(
        self, agent_id: int, rid: int, cached: int, prefill: int, t: float,
        *, replica: Optional[int] = None,
    ) -> None:
        self._push(
            agent_id,
            PrefixHit(agent_id, self._t(t), rid, cached, prefill,
                      replica=replica),
        )

    def on_stage_complete(
        self, agent_id: int, stage: int, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        ev = StageCompleted(agent_id, self._t(t), stage, replica=replica)
        self._push(agent_id, ev)
        # closed-loop continuation: runs INSIDE the backend's emit, which
        # precedes its stage-exhaustion check — an appended stage keeps
        # the agent alive in the same event/iteration
        self.svc._advance_closed_loop(ev)

    def on_closed_loop_stage(
        self, agent_id: int, stage: int, new_tokens: int, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        """In-band closed-loop advancement during a concurrent fleet slice.

        The fleet calls this from the serving child's worker thread
        (serialized under its ``_cl_lock``) so the session can append the
        next stage before the child's stage-exhaustion check; the
        corresponding ``on_stage_complete`` arrives later, at buffer
        replay, and must NOT re-run the session — the service records the
        (agent, stage) pair to suppress it.  No event is pushed here: the
        replayed ``StageCompleted`` is the one canonical record, keeping
        the event stream bit-identical to sequential advancement.
        """
        self.svc._advance_closed_loop_inband(
            agent_id, stage, new_tokens, self._t(t)
        )

    def on_agent_complete(
        self, agent_id: int, t: float, *, replica: Optional[int] = None
    ) -> None:
        tw = self._t(t)
        handle = self.svc.handles.get(agent_id)
        arrival = handle.arrival if handle is not None else 0.0
        self._push(agent_id, AgentCompleted(agent_id, tw, tw - arrival,
                                            replica=replica))

    # fault-tolerance events (PR 8).  Replica-scoped events arrive with
    # agent_id=-1: no handle records them, but the recorder's per-type
    # counts and any raw-listener consumer still see them in-stream.

    def on_replica_failed(
        self, agent_id: int, reason: str, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        self._push(agent_id, ReplicaFailed(agent_id, self._t(t),
                                           reason, replica=replica))

    def on_replica_recovered(
        self, agent_id: int, t: float, *, replica: Optional[int] = None
    ) -> None:
        self._push(agent_id, ReplicaRecovered(agent_id, self._t(t),
                                              replica=replica))

    def on_requeued(
        self, agent_id: int, from_replica: int, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        self._push(agent_id, AgentRequeued(agent_id, self._t(t),
                                           from_replica, replica=replica))

    # suspension events (PR 9): closed-loop think time between stages.
    # ``until`` is a timestamp too — the fleet channel pre-converts it
    # alongside ``t``, so ``self._t`` is the identity there and the real
    # conversion on unreplicated backends.

    def on_suspend(
        self, agent_id: int, stage: int, until: float, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        self._push(
            agent_id,
            AgentSuspended(agent_id, self._t(t), stage, self._t(until),
                           replica=replica),
        )

    def on_resume(
        self, agent_id: int, t: float, *, replica: Optional[int] = None
    ) -> None:
        self._push(agent_id, AgentResumed(agent_id, self._t(t),
                                          replica=replica))

    def on_admission_deferred(
        self, agent_id: int, rid: int, t: float, *,
        replica: Optional[int] = None,
    ) -> None:
        self._push(agent_id, AdmissionDeferred(agent_id, self._t(t), rid,
                                               replica=replica))


class AgentService:
    """Backend-agnostic serving facade (see module docstring)."""

    def __init__(self, backend: Backend, *, record_events: bool = True):
        """``record_events=False`` keeps only aggregate counts and JCTs —
        per-event objects are not retained on the handles, which matters
        for paper-scale benchmark sweeps (thousands of admissions/tokens).
        Hooks and status/stage bookkeeping still work either way."""
        self.backend = backend
        self.handles: dict[int, AgentHandle] = {}
        self.recorder = MetricsRecorder()
        self.record_events = record_events
        self._next_id = 0
        self._in_callback = False    # closed-loop re-entrancy guard
        # (agent_id, stage) pairs whose session already ran in-band
        # during a concurrent fleet slice; the replayed StageCompleted
        # consumes its pair instead of re-running the session
        self._cl_done: set = set()
        backend.set_listener(_Dispatcher(self))

    # ------------------------------------------------------- constructors

    #: ReplicatedBackend-level kwargs peeled off ``**kw`` by the ``sim`` /
    #: ``engine`` constructors (everything else goes to the child backends)
    _FLEET_KW = (
        "fault_plan", "watchdog_timeout", "watchdog_retries",
        "watchdog_backoff", "think_time_accrual", "fleet_workers",
        "steal_threshold", "steal_interval", "retain_agents",
    )

    @classmethod
    def sim(
        cls, scheduler: str = "justitia", *, record_events: bool = True,
        replicas: int = 1, router: str = "round_robin", seed: int = 0, **kw
    ) -> "AgentService":
        """Service over the discrete-event simulator (paper-scale runs).

        ``replicas > 1`` builds a fleet of identical ``SimBackend`` children
        behind a :class:`ReplicatedBackend`, sharding agents via ``router``
        (each replica gets its own scheduler instance and the full ``**kw``
        pool — pass per-replica capacity, not fleet capacity).  Fleet-level
        fault-tolerance kwargs (``fault_plan`` / ``watchdog_*``) go to the
        :class:`ReplicatedBackend`, the rest to the children.
        """
        from repro_torch.api.backend import SimBackend

        fleet_kw = {k: kw.pop(k) for k in cls._FLEET_KW if k in kw}

        def make():
            return SimBackend(scheduler, **kw)

        return cls._maybe_replicated(
            make, replicas, router, seed, record_events, fleet_kw
        )

    @classmethod
    def engine(
        cls, model, params, scheduler: str = "justitia", *,
        record_events: bool = True, replicas: int = 1,
        router: str = "round_robin", seed: int = 0, **kw
    ) -> "AgentService":
        """Service over the real PyTorch continuous-batching engine.

        ``replicas > 1`` builds N engines (sharing ``model``/``params`` but
        each with its own KV pool, batch slots, and scheduler) behind a
        :class:`ReplicatedBackend`; replica k synthesizes prompts from
        ``seed + k`` so fleets are deterministic but decorrelated.
        Fleet-level fault-tolerance kwargs (``fault_plan`` / ``watchdog_*``)
        go to the :class:`ReplicatedBackend`, the rest to the children.
        """
        from repro_torch.api.backend import EngineBackend

        fleet_kw = {k: kw.pop(k) for k in cls._FLEET_KW if k in kw}
        counter = iter(range(replicas if replicas > 1 else 1))

        def make():
            return EngineBackend(
                model, params, scheduler, seed=seed + next(counter), **kw
            )

        return cls._maybe_replicated(
            make, replicas, router, seed, record_events, fleet_kw
        )

    @classmethod
    def replicated(
        cls, children, *, router: str = "round_robin", seed: int = 0,
        record_events: bool = True, **fleet_kw
    ) -> "AgentService":
        """Service over an explicit fleet (any mix of backend types).

        ``**fleet_kw`` forwards fault-tolerance knobs (``fault_plan``,
        ``watchdog_timeout``/``watchdog_retries``/``watchdog_backoff``) to
        the :class:`ReplicatedBackend`.
        """
        from repro_torch.api.replicated import ReplicatedBackend

        return cls(
            ReplicatedBackend(children, router=router, seed=seed,
                              **fleet_kw),
            record_events=record_events,
        )

    @classmethod
    def _maybe_replicated(
        cls, make_child, replicas: int, router: str, seed: int,
        record_events: bool, fleet_kw: Optional[dict] = None,
    ) -> "AgentService":
        if replicas <= 1:
            if fleet_kw:
                raise ValueError(
                    f"{sorted(fleet_kw)} require a replicated fleet — "
                    f"pass replicas > 1"
                )
            return cls(make_child(), record_events=record_events)
        from repro_torch.api.replicated import ReplicatedBackend

        children = [make_child() for _ in range(replicas)]
        return cls(
            ReplicatedBackend(children, router=router, seed=seed,
                              **(fleet_kw or {})),
            record_events=record_events,
        )

    # --------------------------------------------------------- lifecycle

    @property
    def now(self) -> float:
        return self.backend.now

    def submit(
        self, spec: AgentSpec, *, hooks: Optional[AgentHooks] = None
    ) -> AgentHandle:
        """Submit one agent; arrival is ``max(spec.arrival, now)``.

        May be called at any point — before, between, or after ``run``
        calls — on both backends (online arrivals).
        """
        if self._in_callback:
            raise RuntimeError(
                "closed-loop stage callbacks must not submit new agents — "
                "see ROADMAP 'closed-loop clients'"
            )
        agent_id = self._next_id
        self._next_id += 1
        # register the handle BEFORE the backend sees the spec: an agent
        # arriving at or before `now` is released inside submit() and its
        # AgentArrived event must find the handle
        handle = AgentHandle(
            agent_id=agent_id,
            spec=spec,
            arrival=float(spec.arrival),
            hooks=hooks or AgentHooks(),
            record_events=self.record_events,
        )
        self.handles[agent_id] = handle
        try:
            arrival = self.backend.submit(spec, agent_id)
        except Exception:
            del self.handles[agent_id]
            raise
        if handle.status == "pending":   # arrival lies in the future
            handle.arrival = arrival
        return handle

    def submit_many(
        self, specs: Iterable[AgentSpec]
    ) -> list[AgentHandle]:
        return [self.submit(s) for s in specs]

    def _advance_closed_loop(self, ev: StageCompleted) -> None:
        """Feed a completed stage to the agent's ``next_stage`` callback
        and submit whatever it returns as the agent's next stage."""
        handle = self.handles.get(ev.agent_id)
        if handle is None or handle.spec.next_stage is None:
            return
        if (ev.agent_id, ev.stage) in self._cl_done:
            # the session already ran in-band during the concurrent slice;
            # re-sync the token mark now that the replayed token events
            # have landed on the handle, exactly where the sequential path
            # would have set it
            self._cl_done.discard((ev.agent_id, ev.stage))
            handle._stage_token_mark = handle.token_count
            return
        outcome = StageOutcome(
            agent_id=ev.agent_id,
            stage=ev.stage,
            time=ev.time,
            new_tokens=handle.token_count - handle._stage_token_mark,
            handle=handle,
        )
        handle._stage_token_mark = handle.token_count
        self._in_callback = True
        try:
            specs = handle.spec.next_stage(outcome)
        finally:
            self._in_callback = False
        if specs:
            # sessions that pin canonical prompt streams / cached-prefix
            # hints for the stage they just returned expose them as
            # ``last_prompt_ids`` / ``last_cached_hints`` (the stock
            # closed-loop families do; plain callables simply don't)
            session = handle.spec.next_stage
            self.backend.submit_stage(
                ev.agent_id,
                list(specs),
                prompt_ids=getattr(session, "last_prompt_ids", None),
                hints=getattr(session, "last_cached_hints", None),
                resume_delay=getattr(session, "last_resume_delay", None),
            )

    def _advance_closed_loop_inband(
        self, agent_id: int, stage: int, new_tokens: int, t: float
    ) -> None:
        """Concurrent-slice twin of :meth:`_advance_closed_loop` (see
        :meth:`_Dispatcher.on_closed_loop_stage`): runs the session with
        the fleet-counted token delta (the handle's counts lag until the
        buffer replay) and records the pair for replay suppression."""
        handle = self.handles.get(agent_id)
        if handle is None or handle.spec.next_stage is None:
            return
        self._cl_done.add((agent_id, stage))
        outcome = StageOutcome(
            agent_id=agent_id,
            stage=stage,
            time=t,
            new_tokens=int(new_tokens),
            handle=handle,
        )
        self._in_callback = True
        try:
            specs = handle.spec.next_stage(outcome)
        finally:
            self._in_callback = False
        if specs:
            session = handle.spec.next_stage
            self.backend.submit_stage(
                agent_id,
                list(specs),
                prompt_ids=getattr(session, "last_prompt_ids", None),
                hints=getattr(session, "last_cached_hints", None),
                resume_delay=getattr(session, "last_resume_delay", None),
            )

    def run(self, until: float) -> None:
        """Advance serving time to ``until`` (workload seconds)."""
        if self._in_callback:
            raise RuntimeError(
                "closed-loop stage callbacks must not call run() — see "
                "ROADMAP 'closed-loop clients'"
            )
        self.backend.run(until)

    def drain(self) -> ServiceResult:
        """Serve everything submitted so far to completion."""
        if self._in_callback:
            raise RuntimeError(
                "closed-loop stage callbacks must not call drain() — see "
                "ROADMAP 'closed-loop clients'"
            )
        res: BackendResult = self.backend.drain()
        # the recorder's jct view is authoritative (it uses true arrival
        # stamps); fall back to the backend's numbers for any agent whose
        # events were not observed (e.g. a listener installed late)
        jct = dict(res.jct)
        jct.update(self.recorder.jct)
        finish = dict(res.finish)
        finish.update(self.recorder.finish)
        return ServiceResult(
            finish=finish,
            jct=jct,
            stats=jct_stats(jct),
            makespan=res.makespan,
            swaps=res.swaps,
            sched_decisions=res.sched_decisions,
            sched_time=res.sched_time,
            backend=self.backend.name,
            metrics=res.metrics,
            event_counts=dict(self.recorder.event_counts),
            per_replica=self.recorder.per_replica_jct_stats(),
            latency=self.recorder.latency_stats(),
        )
