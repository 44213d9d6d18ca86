"""Discrete-event simulator of a vLLM-style continuous-batching backend.

Models the serving semantics the paper builds on (vLLM + App. C):

  * a shared KV pool of ``total_kv`` token units (paper's M);
  * continuous batching: every running sequence decodes at ``decode_rate``
    tokens/s (per-iteration latency statistically stable — paper fn. 2);
  * prefill occupies the prompt's KV immediately at admission and takes
    ``p / prefill_rate`` seconds before decoding starts;
  * non-preemptive admission: waiting requests never preempt running ones;
  * on memory exhaustion, the running inference with the *worst* scheduler
    key is swapped out (KV to host), keeping its progress; the swapped queue
    has absolute priority for re-admission and blocks new admissions
    (exactly vLLM's recompute/swap policy, per the paper's footnote 3).

The scheduler policy objects from ``repro.core.schedulers`` are used
unmodified — the same classes drive the real JAX engine.  Time unit:
seconds; service unit: KV token-time (token·seconds scaled by decode_rate
to match the cost model's token·iterations — see ``kv_unit_scale``).

Event-indexed core
------------------
The scheduling loop does no per-event rescans of queues or probes over the
whole running set:

  * **Calendar heaps** carry each running sequence's finish time and
    prefill boundary as ``(time, rid, version)`` entries; a state change
    (admit, swap, resume) bumps the sequence's ``version`` so stale
    entries are discarded lazily on pop — no ``min()`` probe over the
    running set ever happens.  Finish times are *cached at (re-)admission*
    and exact by construction: decode progress is the stable closed form
    ``d_base + (t - prefill_done) * decode_rate`` anchored only at
    (re-)admission, never at accounting points.
  * **Service accounting is lazy.**  A sequence is credited
    (``sched.on_service``) only when its *own* state changes — admission,
    swap out/in, finish — because the KV token-time integral over
    piecewise-linear occupancy telescopes exactly across any partition of
    the interval.  Dynamic policies (``sched.dynamic``), whose keys read
    the service counters at decision time, instead get a full refresh at
    every event — which reproduces the reference core's eager sweep
    bit-for-bit (see below).
  * **Queues are ``repro.core.OrderedQueue``** — static-key policies keep
    the waiting/swapped queues sorted by construction (one key evaluation
    per request, ever); agent-keyed dynamic policies (VTC, SRJF) use
    grouped invalidation, repositioning only the freshly-serviced agents'
    requests per admission pass.

Pool occupancy and the saturation probe remain O(running) sweeps — but
``running`` is bounded by the pool size M, not by the number of agents, so
the loop stays O(events · log n) in workload size.  The sweeps reproduce
the *exact float arithmetic* of the retained pre-rewrite core
(``repro_torch.sim.reference.ReferenceClusterSim``, same ordered sums over the
same stable decode form): saturation and finish events frequently land
within 1e-10 of each other under contention, and both cores must order
them identically or swap decisions diverge.  The equivalence property
tests and the ``benchmarks/perf.py`` oracle pin the two cores to
identical completion orders and JCTs.

The core is *incremental*: ``submit`` registers agents online at any time,
``advance(until)`` processes events up to a horizon (so completions are
observable mid-run — the replicated fleet's load-aware routers depend on
this), and ``drain`` runs to empty.  ``run(agents)`` is the legacy one-shot
wrapper.

The simulator emits the same duck-typed lifecycle callbacks as the engine
(``on_arrival``, ``on_admit``, ``on_swap_out``, ``on_swap_in``,
``on_stage_complete``, ``on_agent_complete``) to an optional ``listener`` —
``repro.api`` builds its backend-agnostic event stream on these.

Discretized token streaming (off by default)
--------------------------------------------
Decoding is a continuous fluid rate here, but with ``token_events=True``
the simulator ALSO emits ``on_token(agent_id, rid, token, t)`` at the
instants the closed-form decode crosses integer token boundaries:
token ``k`` of a sequence is stamped ``prefill_done + (k - d_base) /
decode_rate`` from the same anchored closed form that drives every event
time, so the stream is exact and bit-identical between this core and the
frozen reference.  The emission is a pure OVERLAY: a sweep at the top of
every event trip reads the closed form and a per-sequence emitted counter
— it never touches the accounting anchors, the calendars, or the
scheduler, so completions/JCTs/swap decisions are bit-identical with the
flag on or off (``tests/test_sim_equivalence.py`` pins this).  Token
"values" are the 0-based index within the request (the sim samples no
real tokens).  Tokens are emitted at event times — between events the
stream is quiet and catches up at the next trip; each trip's batch is
emitted time-sorted and the sweep runs before any of the trip's own
emits, so the stream is timestamp-monotone per agent and globally.  The
sweep is O(running + tokens) per event, which is why it is gated off by
default.

Closed-loop clients
-------------------
``append_stage`` extends a live agent's stage list at any time — including
from inside an ``on_stage_complete`` listener callback, which both cores
deliberately emit BEFORE checking whether the agent has stages left, so a
callback-appended stage seamlessly continues the agent (this is what
``repro.api``'s closed-loop ``AgentSpec.next_stage`` builds on).  Listener
callbacks must NOT re-enter ``advance``/``drain`` (guarded).

Suspended agents (PR 9)
-----------------------
A closed-loop stage appended with ``resume_delay > 0`` does not submit at
the stage boundary: the agent SUSPENDS for the delay (tool-call / user
think time), holding no decode slot, and its conversation-tail KV sits
under the ``suspend_retention`` policy — ``hold`` keeps it resident and
charged against the pool, ``spill`` parks it host-side for a
``swap_penalty`` restore surcharge at resume, ``drop`` releases it
outright.  Memory pressure victimizes suspended agents BEFORE running
ones: admission fit-failures and the saturation trip escalate held KV
hold→spill one agent at a time (oldest first) and only swap a running
sequence when nothing is held.  Strictly flag-gated: with no suspensions
``_held_total`` stays 0.0 and every adjusted expression reduces to the
pre-PR-9 arithmetic bit-for-bit.  LOCKSTEP: the frozen reference core
carries the identical model.
"""

from __future__ import annotations

import dataclasses
import heapq
import time as _time
from typing import Any, Sequence

from repro_torch.core.cost import InferenceSpec, MemoryFamily, inference_cost
from repro_torch.core.queueing import OrderedQueue
from repro_torch.core.schedulers import AgentScheduler, Request


@dataclasses.dataclass
class SimAgent:
    """An agent submitted to the cluster."""

    agent_id: int
    arrival: float
    stages: list[list[InferenceSpec]]           # stage -> parallel inferences
    predicted_cost: float                        # fed to the scheduler
    true_cost: float = 0.0                       # for metrics
    family: MemoryFamily = MemoryFamily.DENSE
    name: str = "agent"
    #: prefix-cache metadata (PR 6; read only with ``prefix_cache=True``):
    #: agents sharing a ``prefix_group`` share a ``shared_prefix``-token
    #: system prompt, and ``cached_hints`` (per stage, per spec) carries
    #: the expected cached conversation-history prefix of each prompt
    prefix_group: str = ""
    shared_prefix: float = 0.0
    cached_hints: Any = None
    #: per-stage think-time delays (PR 9): ``resume_delays[j]`` seconds of
    #: suspension inserted before stage ``j`` submits (``None``: never)
    resume_delays: Any = None

    # runtime
    finish: float = float("inf")
    next_stage: int = 0
    live_inferences: int = 0


@dataclasses.dataclass
class _Running:
    req: Request
    admit_time: float
    prefill_done: float          # absolute time decoding starts
    d_base: float                # decoded tokens at (re-)admission anchor
    decoded_at_last: float       # decoded tokens at last service credit
    last_account: float          # time of last service credit
    fin: float = float("inf")    # finish time, cached at (re-)admission
    swapped: bool = False
    version: int = 0             # invalidates stale calendar-heap entries
    order: int = 0               # (re-)admission sequence number
    key: Any = None              # cached static scheduler key
    tokens_emitted: int = 0      # token boundaries streamed (token_events)

    def decoded(self, t: float, decode_rate: float) -> float:
        """Stable closed form, anchored at (re-)admission only.

        Identical (bit-for-bit) to the reference core's; the snap window
        mirrors the historical accounting's float-Zeno guard.
        """
        if t <= self.prefill_done:
            d = self.d_base
        else:
            d = self.d_base + (t - self.prefill_done) * decode_rate
        cap = self.req.spec.decode
        if cap - d < 1e-6:
            return float(cap)
        return d

    def finish_time(self, decode_rate: float) -> float:
        rem = self.req.spec.decode - self.decoded_at_last
        return max(self.prefill_done, self.last_account) + rem / decode_rate


@dataclasses.dataclass
class SimResult:
    jct: dict[int, float]                  # agent_id -> completion - arrival
    finish: dict[int, float]               # agent_id -> absolute completion
    sched_decisions: int = 0
    sched_time: float = 0.0                # wall-clock spent in scheduler code
    swaps: int = 0
    makespan: float = 0.0
    events: int = 0                        # discrete events processed
    key_evals: int = 0                     # scheduler request_key invocations
    sorts: int = 0                         # queue re-sorts (dynamic policies)
    peak_occupancy: float = 0.0            # max pool occupancy observed
    # watermark admission control (populated only with
    # ``admission_watermark=(low, high)``; see ClusterSim.__init__)
    admission_deferrals: int = 0           # distinct requests ever deferred
    wm_admit_peak: float = 0.0             # max occ-after-admit (new admits)
    wm_bypass_admits: int = 0              # above-high admits on an idle pool
    # prefix-cache accounting (populated only with ``prefix_cache=True``)
    prefill_tokens_saved: float = 0.0
    agent_prefill_tokens: dict[int, float] = dataclasses.field(
        default_factory=dict
    )
    agent_hit_tokens: dict[int, float] = dataclasses.field(
        default_factory=dict
    )
    # suspension accounting (PR 9; populated only when closed-loop stages
    # carry a ``resume_delay``)
    suspensions: int = 0
    resumes: int = 0
    suspend_spills: int = 0                # hold→spill escalations + spills
    held_peak: float = 0.0                 # max KV held by suspended agents


class ClusterSim:
    def __init__(
        self,
        scheduler: AgentScheduler,
        total_kv: float,
        decode_rate: float = 30.0,       # tokens/s per running sequence
        prefill_rate: float = 4000.0,    # prompt tokens/s
        swap_penalty: float = 0.2,       # seconds added on re-admission
        listener: Any = None,
        token_events: bool = False,
        prefix_cache: bool = False,
        admission_watermark: Any = None,
        suspend_retention: str = "hold",
        retain_results: bool = True,
    ):
        self.sched = scheduler
        #: streaming mode (PR 10): with ``retain_results=False`` a
        #: completed agent's record is evicted immediately — no
        #: ``result.finish``/``result.jct`` entry, no ``_by_id`` object —
        #: so a fleet can stream millions of agents through under
        #: constant memory, consuming completions via listener events
        #: only.  Strictly flag-gated: True (the default) keeps every
        #: result dict and the drained snapshot exactly as before.
        self.retain_results = bool(retain_results)
        self.m = float(total_kv)
        self.decode_rate = float(decode_rate)
        self.prefill_rate = float(prefill_rate)
        self.swap_penalty = float(swap_penalty)
        self.listener = listener
        self.token_events = bool(token_events)
        #: analytic prefix-cache model (PR 6): an admission's prefill
        #: event is shortened by the request's modeled cache hit and only
        #: the uncached suffix is charged as prefill service.  Pool
        #: occupancy stays the full logical prompt (the engine's shared
        #: blocks dedup physically, not logically).  Strictly flag-gated:
        #: off, every expression reduces to the pre-cache arithmetic
        #: bit-for-bit.  LOCKSTEP: the frozen reference core carries the
        #: identical model (frozen-oracle invariant, like token_events).
        self.prefix_cache = bool(prefix_cache)
        self._seeded_groups: set[str] = set()
        #: watermark admission control (PR 8): ``(low_frac, high_frac)``
        #: of the pool.  While anything is running, a NEW admission that
        #: would lift occupancy above the high watermark is deferred, and
        #: once gated the gate stays shut until occupancy drains to the
        #: low watermark (hysteresis) — trading queueing delay for the
        #: swap-thrash regime.  Swapped re-admissions are never gated
        #: (they hold pool-priority state), and an idle pool bypasses the
        #: gate entirely (progress guarantee).  Strictly flag-gated: with
        #: ``None`` the admission pass is untouched bit-for-bit.
        #: LOCKSTEP: the frozen reference core carries the identical gate.
        if admission_watermark is not None:
            low, high = admission_watermark
            if not (0.0 < low <= high <= 1.0):
                raise ValueError(
                    f"admission_watermark must satisfy 0 < low <= high <= 1,"
                    f" got {admission_watermark!r}"
                )
            self._wm = (low * self.m, high * self.m)
        else:
            self._wm = None
        self._wm_gated = False
        self._wm_emitted: set[int] = set()
        #: suspended-agent KV retention (PR 9): an agent in think time
        #: (closed-loop ``resume_delay``) holds no decode slot; ``hold``
        #: keeps its conversation tail resident (charged to the pool via
        #: ``_held_total``), ``spill`` parks it host-side for a
        #: ``swap_penalty`` restore surcharge at resume, ``drop`` releases
        #: it outright.  Under pressure held KV escalates hold→spill
        #: BEFORE any running sequence is swapped.  Strictly flag-gated:
        #: with no suspensions ``_held_total`` stays 0.0 and every
        #: adjusted expression is bit-identical (``x - 0.0 == x``).
        #: LOCKSTEP: the frozen reference carries the identical model.
        if suspend_retention not in ("hold", "spill", "drop"):
            raise ValueError(
                f"suspend_retention must be 'hold', 'spill' or 'drop',"
                f" got {suspend_retention!r}"
            )
        self.suspend_retention = suspend_retention
        # pending resumes: (resume_time, seq, agent_id) min-heap
        self._resume_heap: list[tuple[float, int, int]] = []
        self._rseq = 0
        self._held: dict[int, float] = {}  # suspended aid -> resident KV
        self._held_total = 0.0
        self._spilled: set[int] = set()    # suspended aids parked host-side
        self._penalized: set[int] = set()  # spilled aids past their restore
        self._in_run = False             # re-entrancy guard (listener rule)

        # clock + result (cumulative across submit/advance/drain rounds)
        self.t = 0.0
        self.result = SimResult(jct={}, finish={})
        self._last_event_t = 0.0

        # pending arrivals: (arrival, agent_id, SimAgent) min-heap
        self._arrivals: list[tuple[float, int, SimAgent]] = []
        self._by_id: dict[int, SimAgent] = {}
        self._live_agents = 0            # submitted, not yet completed

        # queues (see repro.core.queueing); key evals are counted by the
        # key functions themselves so static caching shows up in the metric.
        # Agent-keyed dynamic policies (VTC, SRJF) use grouped invalidation:
        # only the serviced agents' requests are repositioned per pass.
        dyn = self.sched.dynamic
        self._grouped = dyn and getattr(self.sched, "agent_keyed", False)
        # agents serviced since the last admission pass (grouped mode):
        # flushed into the queues' dirty-group sets at each pass
        self._dirty_agents: set[int] = set()
        self._waiting: OrderedQueue = OrderedQueue(
            self._req_key,
            dynamic=dyn,
            group_fn=(lambda req: req.agent_id) if self._grouped else None,
        )
        self._swapped: OrderedQueue = OrderedQueue(
            self._run_key,
            dynamic=dyn,
            group_fn=(lambda r: r.req.agent_id) if self._grouped else None,
        )

        # running set (insertion == admission order, like the reference's
        # list) + calendar heaps ((time, rid, version), lazily purged)
        self._running: dict[int, _Running] = {}
        self._fin_heap: list[tuple[float, int, int]] = []
        self._pref_heap: list[tuple[float, int, int]] = []
        # completion-batch tolerance: the stable decode form snaps to the
        # cap within 1e-6 tokens (float Zeno guard) — the same window in
        # seconds bounds how far a finish entry can trail its snap
        self._fin_eps = 1e-6 / self.decode_rate

        self._rid = 0
        self._order = 0
        self._sched_clock = 0.0
        self._decisions = 0

    # ---------------------------------------------------------------- emits

    def _emit(self, event: str, *args) -> None:
        if self.listener is not None:
            fn = getattr(self.listener, event, None)
            if fn is not None:
                fn(*args)

    def _sweep_tokens(self, t: float) -> None:
        """Emit every token boundary the closed-form decode crossed by ``t``.

        Pure overlay (see module doc): reads only the anchored closed form
        and advances the per-sequence ``tokens_emitted`` counter — the
        accounting anchors, the calendars, and the scheduler are untouched,
        so dynamics with the flag on are bit-identical to the flag off.
        Runs at the top of every event trip, before any of the trip's own
        emits.  Every boundary crossed since the previous sweep lies in
        ``(prev_event, t]``, so sorting each sweep's batch by (time,
        running-set position, token index) keeps the whole stream — per
        agent and globally — timestamp-monotone even when parallel
        requests' backlogs are flushed together.  LOCKSTEP: the reference
        core carries the identical sweep (same float expressions, same
        running-set iteration order, same sort key).
        """
        rate = self.decode_rate
        batch: list[tuple[float, int, int, int, int]] = []
        for idx, r in enumerate(self._running.values()):
            d = r.decoded(t, rate)
            n = int(d + 1e-9)
            cap = int(r.req.spec.decode)
            if n > cap:
                n = cap
            k = r.tokens_emitted
            if n <= k:
                continue
            pf = r.prefill_done
            base = r.d_base
            aid, rid = r.req.agent_id, r.req.rid
            while k < n:
                k += 1
                tk = pf + (k - base) / rate
                if tk > t:          # cap-snap window: never post-date the
                    tk = t          # event that observed the boundary
                batch.append((tk, idx, k, aid, rid))
            r.tokens_emitted = n
        batch.sort(key=lambda e: e[:3])
        for tk, _, k, aid, rid in batch:
            self._emit("on_token", aid, rid, k - 1, tk)

    # ----------------------------------------------------------------- keys

    def _req_key(self, req: Request):
        self.result.key_evals += 1
        return self.sched.request_key(req, self.t)

    def _run_key(self, r: _Running):
        return self._req_key(r.req)

    # ------------------------------------------------------------ occupancy

    def _occupancy(self, t: float) -> float:
        """Pool occupancy at ``t``: the reference's ordered sum, exactly.

        O(running) — bounded by the pool size M, not by workload size.
        Saturation and finish events frequently coincide to within 1e-10
        under contention, so this must be the reference core's float
        arithmetic to the bit or the two cores order them differently.

        Internal use only: ``t`` must be the current event time (for
        dynamic policies the accounting anchors must be at ``t``, which
        every internal call site guarantees); ``occupancy_now`` is the
        anytime-safe public probe.
        """
        occ = 0.0
        if self.sched.dynamic:
            # the per-event accounting sweep keeps every anchor at the
            # current event time, so decoded_at_last IS decoded(t) —
            # bit-for-bit (refresh writes the stable form into it)
            for r in self._running.values():
                occ += r.req.spec.prefill + r.decoded_at_last
            return occ
        # inlined _Running.decoded (hot: ~2 sweeps per event)
        rate = self.decode_rate
        for r in self._running.values():
            pf = r.prefill_done
            d = r.d_base if t <= pf else r.d_base + (t - pf) * rate
            cap = r.req.spec.decode
            if cap - d < 1e-6:
                d = cap
            occ += r.req.spec.prefill + d
        return occ

    def _saturation_time(self, t: float) -> float:
        """When does pool occupancy hit M at current decode rates?

        Only sequences whose prefill has completed are growing; a prefill
        completion is itself an event (see the calendar), after which this
        is recomputed with the new rate.  Bit-exact mirror of the
        reference's probe (one sweep yields both sums).
        """
        rate = self.decode_rate
        eps = t + 1e-12
        occ = 0.0
        growing = 0
        if self.sched.dynamic:
            # anchors are at t (see _occupancy): decoded_at_last is exact
            for r in self._running.values():
                d = r.decoded_at_last
                occ += r.req.spec.prefill + d
                if r.prefill_done <= eps and d < r.req.spec.decode:
                    growing += 1
        else:
            for r in self._running.values():
                pf = r.prefill_done
                d = r.d_base if t <= pf else r.d_base + (t - pf) * rate
                cap = r.req.spec.decode
                if cap - d < 1e-6:
                    d = cap
                occ += r.req.spec.prefill + d
                if pf <= eps and d < cap:
                    growing += 1
        if growing == 0:
            return float("inf")
        return t + max(0.0, self.m - occ - self._held_total) / (
            growing * rate
        )

    # ----------------------------------------------------------- accounting

    def _credit(self, r: _Running, now: float) -> None:
        """Credit service dealt to ``r`` since its own last accounting.

        Decode totals are differences of the stable closed form, so they
        telescope exactly over any partition; the KV token-time integral
        telescopes in exact arithmetic (float association differs across
        partitions, which only dynamic policies observe — and they refresh
        on the reference's schedule, see :meth:`_refresh_all`).
        """
        dt_total = now - r.last_account
        if dt_total <= 0:
            return
        dec_start = max(r.last_account, r.prefill_done)
        dt_dec = max(0.0, now - dec_start)
        new_decoded = r.decoded(now, self.decode_rate)
        d_tokens = new_decoded - r.decoded_at_last
        occ0 = r.req.spec.prefill + r.decoded_at_last
        kv_tt = (occ0 * dt_total + 0.5 * d_tokens * dt_dec) * self.decode_rate
        self.sched.on_service(
            r.req.agent_id, kv_token_time=kv_tt, decode_tokens=d_tokens
        )
        if self._grouped:
            self._dirty_agents.add(r.req.agent_id)
        r.decoded_at_last = new_decoded
        r.last_account = now

    def _refresh_all(self, now: float) -> None:
        """Bring every running sequence's service counters current.

        Needed only for dynamic policies, whose admission keys read the
        scheduler's per-agent service counters at decision time.  This is
        the hot per-event O(running) sweep for VTC/SRJF, so the credit
        arithmetic of :meth:`_credit` is inlined — the two must stay in
        lockstep (the equivalence property tests pin both to the
        reference core).
        """
        rate = self.decode_rate
        on_service = self.sched.on_service
        dirty = self._dirty_agents
        for r in self._running.values():
            la = r.last_account
            dt_total = now - la
            if dt_total <= 0.0:
                continue
            pf = r.prefill_done
            d0 = r.decoded_at_last
            if now <= pf:
                new_decoded = r.d_base
            else:
                new_decoded = r.d_base + (now - pf) * rate
            cap = r.req.spec.decode
            if cap - new_decoded < 1e-6:
                new_decoded = float(cap)        # snap (float Zeno)
            dt_dec = now - pf if la <= pf else dt_total
            if dt_dec < 0.0:
                dt_dec = 0.0
            d_tokens = new_decoded - d0
            kv_tt = (
                (r.req.spec.prefill + d0) * dt_total
                + 0.5 * d_tokens * dt_dec
            ) * rate
            on_service(
                r.req.agent_id, kv_token_time=kv_tt, decode_tokens=d_tokens
            )
            dirty.add(r.req.agent_id)
            r.decoded_at_last = new_decoded
            r.last_account = now

    # ----------------------------------------------------- running-set ops

    def _add_running(self, r: _Running, now: float) -> None:
        r.order = self._order
        self._order += 1
        r.fin = r.finish_time(self.decode_rate)
        self._running[r.req.rid] = r
        if r.prefill_done > now + 1e-12:
            heapq.heappush(
                self._pref_heap, (r.prefill_done, r.req.rid, r.version)
            )
        heapq.heappush(self._fin_heap, (r.fin, r.req.rid, r.version))

    def _remove_running(self, r: _Running) -> None:
        del self._running[r.req.rid]
        r.version += 1

    # ------------------------------------------------------------ admission

    def _resume(self, r: _Running, now: float, deferred: list) -> None:
        r.swapped = False
        r.last_account = now
        r.prefill_done = max(r.prefill_done, now + self.swap_penalty)
        r.d_base = r.decoded_at_last
        self._add_running(r, now)
        deferred.append(("on_swap_in", r.req.agent_id, r.req.rid, now))

    # ------------------------------------------------------------ suspension

    def _suspend(self, agent: SimAgent, delay: float, now: float) -> None:
        """Park a closed-loop agent for ``delay`` seconds of think time.

        The agent holds no decode slot; under ``hold`` retention its
        conversation tail (the completed stage's last inference) stays
        resident and charged against the pool via ``_held_total``; under
        ``spill``/``drop`` nothing stays resident (spill pays the
        ``swap_penalty`` restore surcharge at resume, drop re-prefills —
        cheap when the prefix-cache model still matches the history).
        """
        aid = agent.agent_id
        stage = agent.next_stage - 1
        until = now + float(delay)
        held = 0.0
        if self.suspend_retention == "hold":
            spec = agent.stages[stage][-1]
            held = float(spec.prefill + spec.decode)
        self._held[aid] = held
        self._held_total += held
        if self.suspend_retention == "spill":
            self._spilled.add(aid)
        self._rseq += 1
        heapq.heappush(self._resume_heap, (until, self._rseq, aid))
        self.result.suspensions += 1
        if self._held_total > self.result.held_peak:
            self.result.held_peak = self._held_total
        _t0 = _time.perf_counter()
        self.sched.on_agent_suspend(aid, now)
        self._sched_clock += _time.perf_counter() - _t0
        self._emit("on_suspend", aid, stage, until, now)

    def _spill_oldest_held(self) -> float:
        """Escalate hold→spill on the oldest held agent; returns freed KV.

        Memory pressure victimizes suspended agents BEFORE running ones:
        admission fit-failures and the saturation trip call this first,
        and only when nothing is held does a running sequence get
        swapped.  The spilled agent pays the ``swap_penalty`` restore
        surcharge at resume, exactly like a swapped sequence.
        """
        for aid, held in self._held.items():
            if held > 0.0:
                self._held[aid] = 0.0
                self._held_total -= held
                self._spilled.add(aid)
                self.result.suspend_spills += 1
                return held
        return 0.0

    def _admit(self, now: float) -> None:
        """Admission pass: swapped queue first, then waiting (vLLM)."""
        # listener emits are deferred past the timed window so the
        # reported scheduler overhead measures policy code only
        deferred: list[tuple] = []
        t0 = _time.perf_counter()
        free = self.m - self._occupancy(now) - self._held_total
        # None (a policy without the version counter) => refresh falls back
        # to sorting whenever the queue is dirty-or-dynamic, always safe
        version = getattr(self.sched, "version", None)
        if self._grouped and self._dirty_agents:
            self._waiting.mark_dirty_many(self._dirty_agents)
            self._swapped.mark_dirty_many(self._dirty_agents)
            self._dirty_agents.clear()
        # swapped queue has absolute priority and blocks new admissions
        if self._swapped:
            self._swapped.refresh(version)
            while self._swapped:
                r = self._swapped.peek()
                need = r.req.spec.prefill + r.decoded_at_last
                if need > free:
                    spilled = self._spill_oldest_held()
                    if spilled > 0.0:
                        free += spilled
                        continue
                    break
                self._swapped.popleft()
                self._resume(r, now, deferred)
                free -= need
        if not self._swapped:
            self._waiting.refresh(version)
            while self._waiting:
                req = self._waiting.peek()
                # the fit check precedes admission so a pass can never push
                # occupancy past M — except for a request larger than the
                # whole pool, which would deadlock the backend; vLLM admits
                # it alone and lets it thrash, so we admit it when the pool
                # is otherwise idle
                fits = req.spec.prefill <= free
                solo_oversized = (
                    not self._running and req.spec.prefill >= self.m
                )
                if not (fits or solo_oversized):
                    spilled = self._spill_oldest_held()
                    if spilled > 0.0:
                        free += spilled
                        continue
                    break
                if self._wm is not None:
                    low, high = self._wm
                    occ_now = self.m - free
                    if self._running:
                        if self._wm_gated and occ_now <= low:
                            self._wm_gated = False
                        if (self._wm_gated
                                or occ_now + req.spec.prefill > high):
                            self._wm_gated = True
                            if req.rid not in self._wm_emitted:
                                self._wm_emitted.add(req.rid)
                                self.result.admission_deferrals += 1
                                deferred.append((
                                    "on_admission_deferred",
                                    req.agent_id, req.rid, now,
                                ))
                            break
                    elif occ_now + req.spec.prefill > high:
                        # idle-pool bypass: admit for progress even above
                        # the high watermark, but record the violation
                        self.result.wm_bypass_admits += 1
                    peak = occ_now + req.spec.prefill
                    if peak > self.result.wm_admit_peak:
                        self.result.wm_admit_peak = peak
                static_key = (
                    None if self.sched.dynamic else self._waiting.head_key()
                )
                self._waiting.popleft()
                # analytic prefix-cache hit shortens the prefill event and
                # the charged prefill service; 0.0 with the cache off, and
                # `x - 0.0 == x` bitwise for positive prefills, so the off
                # path is unchanged
                hit = self._prefix_hit(req, now, deferred)
                pf = now + (req.spec.prefill - hit) / self.prefill_rate
                self.sched.on_service(
                    req.agent_id, prefill_tokens=req.spec.prefill - hit
                )
                if self._grouped:
                    self._dirty_agents.add(req.agent_id)
                deferred.append(("on_admit", req.agent_id, req.rid, now))
                self._add_running(
                    _Running(
                        req=req,
                        admit_time=now,
                        prefill_done=pf,
                        d_base=0.0,
                        decoded_at_last=0.0,
                        last_account=now,
                        key=static_key,
                    ),
                    now,
                )
                free -= req.spec.prefill
                if free < 0:          # only reachable via solo_oversized
                    break
        elif not self._running:
            # swapped head cannot fit but nothing is running: re-admit it
            # anyway (its KV footprint is what it is — vLLM would page)
            r = self._swapped.popleft()
            self._resume(r, now, deferred)
            free -= r.req.spec.prefill + r.decoded_at_last
        self._decisions += 1
        self._sched_clock += _time.perf_counter() - t0
        # occupancy after the pass == M - remaining free (O(1) metric; the
        # tracked ``free`` already absorbed every admission's footprint)
        occ = self.m - free
        if occ > self.result.peak_occupancy:
            self.result.peak_occupancy = occ
        for ev in deferred:
            self._emit(*ev)

    def _prefix_hit(self, req: Request, now: float,
                    deferred: list) -> float:
        """Modeled cache hit for an admission (0.0 with the cache off).

        The hit is the larger of the request's conversation-history hint
        (``Request.cached_prefix``: a later turn re-sends everything the
        previous turn cached) and the agent's family-shared system prefix
        — the latter only once some agent of the group has admitted and
        seeded the cache.  Admission itself seeds the group.  The model
        is optimistic about eviction (the engine may report less under
        pool pressure) and block-oblivious (the engine rounds hits down
        to full blocks); the equivalence test sizes prompts so both
        effects vanish.
        """
        if not self.prefix_cache:
            return 0.0
        agent = self._by_id[req.agent_id]
        base = 0.0
        if agent.prefix_group and agent.prefix_group in self._seeded_groups:
            base = float(agent.shared_prefix)
        hit = max(base, float(req.cached_prefix))
        if hit > req.spec.prefill:
            hit = float(req.spec.prefill)
        if agent.prefix_group:
            self._seeded_groups.add(agent.prefix_group)
        res = self.result
        aid = req.agent_id
        res.agent_prefill_tokens[aid] = (
            res.agent_prefill_tokens.get(aid, 0.0) + req.spec.prefill
        )
        if hit > 0.0:
            res.agent_hit_tokens[aid] = (
                res.agent_hit_tokens.get(aid, 0.0) + hit
            )
            res.prefill_tokens_saved += hit
            deferred.append(
                ("on_prefix_hit", aid, req.rid, hit, float(req.spec.prefill),
                 now)
            )
        return hit

    def hit_fractions(self) -> dict[int, float]:
        """Per-agent modeled hit fraction: cached / total prefill tokens."""
        return {
            aid: self.result.agent_hit_tokens.get(aid, 0.0) / tot
            for aid, tot in self.result.agent_prefill_tokens.items()
            if tot > 0
        }

    # ------------------------------------------------------ calendar peeks

    def _peek_fin(self) -> float:
        heap = self._fin_heap
        while heap:
            t, rid, ver = heap[0]
            r = self._running.get(rid)
            if r is None or r.version != ver:
                heapq.heappop(heap)
                continue
            return t
        return float("inf")

    def _peek_pref(self) -> float:
        # mirrors the reference probe min(pf for pf > t + 1e-12): an entry
        # at or before the current instant is no longer a boundary (its
        # sequence already counts as growing in the sweeps) and is purged
        heap = self._pref_heap
        eps = self.t + 1e-12
        while heap:
            t, rid, ver = heap[0]
            r = self._running.get(rid)
            if r is None or r.version != ver or t <= eps:
                heapq.heappop(heap)
                continue
            return t
        return float("inf")

    # ------------------------------------------------------------ submission

    def submit(self, agent: SimAgent) -> float:
        """Register one agent online; arrival clamps to ``max(arrival, t)``."""
        agent.arrival = max(float(agent.arrival), self.t)
        self._by_id[agent.agent_id] = agent
        heapq.heappush(self._arrivals, (agent.arrival, agent.agent_id, agent))
        self._live_agents += 1
        return agent.arrival

    def append_stage(
        self, agent_id: int, stages: list[list[InferenceSpec]],
        hints: Any = None,
        resume_delay: float = 0.0,
    ) -> None:
        """Append follow-up stages to a live agent (closed-loop clients).

        Legal at any point before the agent completes — including from
        inside an ``on_stage_complete`` listener callback, which fires
        BEFORE the core checks for remaining stages, so an appended stage
        seamlessly continues the agent in the same event.  The callback
        must not re-enter ``advance``/``drain``.

        ``hints`` (optional, aligned with ``stages``) carries per-spec
        expected cached-prefix lengths for the prefix-cache model.
        ``resume_delay > 0`` (seconds of think time, PR 9) suspends the
        agent for that long before the FIRST appended stage submits.
        """
        agent = self._by_id.get(agent_id)
        if agent is None or agent.finish != float("inf"):
            raise ValueError(f"agent {agent_id} is not live")
        if resume_delay and resume_delay > 0.0 and stages:
            if agent.resume_delays is None:
                agent.resume_delays = [0.0] * len(agent.stages)
            while len(agent.resume_delays) < len(agent.stages):
                agent.resume_delays.append(0.0)
            agent.resume_delays.append(float(resume_delay))
            agent.resume_delays.extend([0.0] * (len(stages) - 1))
        if hints is not None:
            if agent.cached_hints is None:
                agent.cached_hints = [None] * len(agent.stages)
            while len(agent.cached_hints) < len(agent.stages):
                agent.cached_hints.append(None)
            agent.cached_hints.extend([list(h) for h in hints])
        agent.stages.extend([list(s) for s in stages])

    def _submit_stage(self, agent: SimAgent, now: float) -> None:
        specs = agent.stages[agent.next_stage]
        hints = None
        if (agent.cached_hints is not None
                and agent.next_stage < len(agent.cached_hints)):
            hints = agent.cached_hints[agent.next_stage]
        agent.next_stage += 1
        agent.live_inferences += len(specs)
        for i, spec in enumerate(specs):
            self._waiting.push(
                Request(
                    agent_id=agent.agent_id,
                    rid=self._rid,
                    spec=spec,
                    submit_time=now,
                    pred_cost=inference_cost(spec, agent.family),
                    cached_prefix=(
                        float(hints[i])
                        if hints is not None and i < len(hints) else 0.0
                    ),
                )
            )
            self._rid += 1

    def cancel(self, agent_id: int) -> bool:
        """Withdraw a never-admitted agent (fleet work stealing, PR 10).

        Legal only while NONE of the agent's requests has ever been
        admitted: either its arrival is still pending, or its whole
        opening stage sits in the waiting queue.  The withdrawal is
        silent — no completion event, no result entry — because the
        caller (the fleet) re-submits the agent elsewhere and emits the
        migration event itself.  The scheduler sees ``on_agent_cancel``
        so arrival-time registrations (records, Justitia's GPS share)
        are released.  Returns False — leaving the sim untouched — when
        the agent is unknown, completed, suspended, past its opening
        stage, or was ever admitted.
        """
        agent = self._by_id.get(agent_id)
        if agent is None or agent.finish != float("inf"):
            return False
        if agent.next_stage == 0:
            # submitted, not yet arrived: unwind silently — the scheduler
            # and listener never saw it
            for i, (_, aid, _a) in enumerate(self._arrivals):
                if aid == agent_id:
                    self._arrivals.pop(i)
                    heapq.heapify(self._arrivals)
                    del self._by_id[agent_id]
                    self._live_agents -= 1
                    return True
            return False
        if agent.next_stage != 1:
            return False         # a later stage implies admitted service
        if (
            agent_id in self._held
            or agent_id in self._spilled
            or any(aid == agent_id for _, _, aid in self._resume_heap)
        ):
            return False         # suspended (implies admitted anyway)
        if any(
            r.req.agent_id == agent_id for r in self._running.values()
        ) or any(r.req.agent_id == agent_id for r in self._swapped):
            return False
        if agent.live_inferences != len(agent.stages[0]):
            return False         # some opening request already ran
        reqs = [req for req in self._waiting if req.agent_id == agent_id]
        if len(reqs) != agent.live_inferences:
            return False
        for req in reqs:
            self._waiting.remove(req)
        del self._by_id[agent_id]
        self._live_agents -= 1
        _t0 = _time.perf_counter()
        self.sched.on_agent_cancel(agent_id, self.t)
        self._sched_clock += _time.perf_counter() - _t0
        return True

    # ------------------------------------------------------------ inspection

    @property
    def live_agents(self) -> int:
        """Agents submitted but not yet completed (in-flight load)."""
        return self._live_agents

    @property
    def busy(self) -> bool:
        return bool(
            self._arrivals or self._waiting or self._running
            or self._swapped or self._resume_heap
        )

    def occupancy_now(self) -> float:
        """Current pool occupancy in KV-token units (anytime-safe)."""
        t = self.t
        rate = self.decode_rate
        return sum(
            r.req.spec.prefill + r.decoded(t, rate)
            for r in self._running.values()
        ) + self._held_total

    # ------------------------------------------------------------- stepping

    def _step(self, until: float) -> bool:
        """Process the next event at or before ``until``; False when none.

        Event cascade mirrors the reference core: arrival > completion >
        (prefill boundary, then the saturation condition).  Within one
        event time multiple trips may fire — each processes exactly one
        arrival or one completion batch or one swap, exactly like one trip
        through the reference loop.
        """
        t_arr = self._arrivals[0][0] if self._arrivals else float("inf")
        t_res = (
            self._resume_heap[0][0] if self._resume_heap else float("inf")
        )
        t_fin = self._peek_fin()
        t_pref = self._peek_pref()
        # the saturation probe is evaluated at the LAST EVENT time, not at
        # self.t: after advance() raised the clock floor past the last
        # event the two differ, and (a) for dynamic policies the anchors
        # (valid only at the last refresh == last event) would read stale,
        # (b) re-basing the linear extrapolation at the horizon would
        # shift the probe in the last float bits.  Occupancy grows
        # linearly, so the absolute saturation time is the same from any
        # base point — and probing from the last event time keeps
        # incremental runs bit-identical to one-shot drains, regardless
        # of how often the driver polls advance().  Crediting the
        # scheduler at horizon times is never allowed for the same
        # reason: on_service partitions must depend only on true events.
        t_sat = (
            self._saturation_time(self._last_event_t)
            if self._running
            else float("inf")
        )
        t_next = min(t_arr, t_res, t_fin, t_sat, t_pref)
        if t_next == float("inf"):
            if self._waiting or self._swapped:
                raise RuntimeError(
                    "simulator deadlock: pool cannot fit pending work"
                )
            return False
        if t_next > until:
            return False
        if (
            len(self._running) == 1
            and t_arr > until
            and t_res > until
            and t_fin > until
            and t_pref > until
        ):
            # single-sequence saturation stall: the only due candidate is
            # the saturation probe, and its jump target (min(fin, next
            # arrival) — both beyond the horizon here) is unreachable this
            # advance().  Bail BEFORE mutating anything so repeated polls
            # leave the event counter, the anchors, and the dynamic
            # policies' service-credit partitions untouched.
            return False
        # clamp to the last EVENT time, not the raised clock floor: after
        # advance() lifted self.t past the last event, processing a stalled
        # event at the horizon would credit dynamic schedulers at
        # poll-dependent times; _last_event_t is exactly where a one-shot
        # drain's clock would stand (in batch runs self.t equals it here)
        t = max(t_next, self._last_event_t)
        self.t = max(self.t, t)
        self._last_event_t = t
        self.result.events += 1
        if self.token_events:
            self._sweep_tokens(t)
        if self.sched.dynamic:
            # dynamic keys (and VTC's counter lift) read the service
            # counters at decision time: replicate the reference's eager
            # per-event accounting sweep at EVERY event, so the counters
            # dynamic policies compare (often to exact ties) match the
            # reference bit-for-bit
            self._refresh_all(t)

        # -- arrivals (one per trip, like the reference loop)
        if t_arr <= t + 1e-12:
            _, _, agent = heapq.heappop(self._arrivals)
            _t0 = _time.perf_counter()
            self.sched.on_agent_arrival(
                agent.agent_id, agent.arrival, agent.predicted_cost
            )
            self._sched_clock += _time.perf_counter() - _t0
            self._decisions += 1
            self._emit("on_arrival", agent.agent_id, t)
            self._submit_stage(agent, t)
            self._admit(t)
            return True

        # -- resumes: think time ended (one per trip, like arrivals)
        if t_res <= t + 1e-12:
            _, _, aid = heapq.heappop(self._resume_heap)
            if aid in self._spilled and aid not in self._penalized:
                # spilled KV pays the swap-in restore surcharge before
                # the next stage submits — one deterministic penalty trip
                self._penalized.add(aid)
                self._rseq += 1
                heapq.heappush(
                    self._resume_heap,
                    (t + self.swap_penalty, self._rseq, aid),
                )
                return True
            held = self._held.pop(aid, 0.0)
            self._held_total -= held
            self._spilled.discard(aid)
            self._penalized.discard(aid)
            self.result.resumes += 1
            agent = self._by_id[aid]
            _t0 = _time.perf_counter()
            self.sched.on_agent_resume(aid, t)
            self._sched_clock += _time.perf_counter() - _t0
            self._emit("on_resume", aid, t)
            self._submit_stage(agent, t)
            self._admit(t)
            return True

        # -- completions: drain the finish calendar within the snap window
        if t_fin <= t + self._fin_eps:
            batch: list[_Running] = []
            while True:
                f = self._peek_fin()
                if f > t + self._fin_eps:
                    break
                _, rid, _ = heapq.heappop(self._fin_heap)
                batch.append(self._running[rid])
            batch.sort(key=lambda r: r.order)   # reference processing order
            for r in batch:
                self._credit(r, t)               # snaps decoded to the cap
                self._remove_running(r)
                agent = self._by_id[r.req.agent_id]
                agent.live_inferences -= 1
                if agent.live_inferences == 0:
                    self._emit(
                        "on_stage_complete", agent.agent_id,
                        agent.next_stage - 1, t,
                    )
                    if agent.next_stage < len(agent.stages):
                        delays = agent.resume_delays
                        delay = (
                            float(delays[agent.next_stage])
                            if delays is not None
                            and agent.next_stage < len(delays)
                            else 0.0
                        )
                        if delay > 0.0:
                            self._suspend(agent, delay, t)
                        else:
                            self._submit_stage(agent, t)
                    else:
                        agent.finish = t
                        if self.retain_results:
                            self.result.finish[agent.agent_id] = t
                            self.result.jct[agent.agent_id] = (
                                t - agent.arrival
                            )
                        self._live_agents -= 1
                        _t0 = _time.perf_counter()
                        self.sched.on_agent_complete(agent.agent_id, t)
                        self._sched_clock += _time.perf_counter() - _t0
                        self._emit("on_agent_complete", agent.agent_id, t)
                        if not self.retain_results:
                            # streaming mode: evict the completed agent
                            # (its live_inferences hit 0, so no other
                            # request in this batch can re-read it)
                            del self._by_id[agent.agent_id]
            self._admit(t)
            return True

        # (prefill boundaries are pure time barriers: the decode closed
        # form needs no transition — the event only exists so the
        # saturation probe is recomputed with the new growth rate.  The
        # entry that triggered this trip is purged by the next _peek_pref.)

        # -- saturation: swap out the worst-priority running inference
        occ_sat = (
            self._occupancy(t) + self._held_total if self._running else 0.0
        )
        if occ_sat >= self.m - 1e-6 and self._running:
            if self._held_total > 0.0:
                # memory pressure victimizes suspended agents first:
                # escalate one hold→spill instead of swapping a runner
                self._spill_oldest_held()
                return True
            if len(self._running) > 1:
                t0 = _time.perf_counter()
                if self.sched.dynamic:
                    self.result.key_evals += len(self._running)
                    victim = max(
                        self._running.values(),
                        key=lambda r: self.sched.request_key(r.req, t),
                    )
                else:
                    # static policies: keys were cached at admission
                    victim = max(self._running.values(), key=lambda r: r.key)
                self._sched_clock += _time.perf_counter() - t0
                self._credit(victim, t)
                self._remove_running(victim)
                victim.swapped = True
                self._swapped.push(victim)
                self.result.swaps += 1
                # the pre-swap occupancy (~M) is the true local maximum
                if occ_sat > self.result.peak_occupancy:
                    self.result.peak_occupancy = occ_sat
                self._emit(
                    "on_swap_out", victim.req.agent_id, victim.req.rid, t
                )
            else:
                # single sequence saturating the pool: let it finish — but
                # never past the next arrival, which must be processed on
                # time (assume p + d < M for all workloads; App. B)
                r = next(iter(self._running.values()))
                fin = r.fin
                if self._arrivals and self._arrivals[0][0] < fin:
                    fin = self._arrivals[0][0]
                if self._resume_heap and self._resume_heap[0][0] < fin:
                    fin = self._resume_heap[0][0]
                if fin > until:
                    # don't overshoot an advance() horizon: a later submit
                    # would clamp its arrival to the overshot clock.  The
                    # jump resumes in a later advance/drain; one-shot
                    # drains (until=inf) never take this path.  Un-count
                    # this trip: a one-shot drain performs the prefill
                    # pops above AND the jump as ONE event, and the
                    # resuming trip will re-count it.
                    self.result.events -= 1
                    return False
                self._credit(r, fin)
                self.t = fin
                self._last_event_t = fin
        return True

    # ------------------------------------------------------------ advancing

    def advance(self, until: float) -> None:
        """Process all events at or before ``until``; raise the clock floor."""
        if self._in_run:
            raise RuntimeError(
                "re-entrant advance() from a listener callback"
            )
        until = float(until)
        self._in_run = True
        try:
            while self._step(until):
                pass
        finally:
            self._in_run = False
        self.t = max(self.t, until)

    def drain(self) -> SimResult:
        """Serve everything submitted so far; cumulative results snapshot."""
        if self._in_run:
            raise RuntimeError("re-entrant drain() from a listener callback")
        self._in_run = True
        try:
            while self._step(float("inf")):
                pass
        finally:
            self._in_run = False
        self.result.sched_decisions = self._decisions
        self.result.sched_time = self._sched_clock
        self.result.sorts = self._waiting.sorts + self._swapped.sorts
        self.result.makespan = self._last_event_t
        return dataclasses.replace(
            self.result,
            jct=dict(self.result.jct),
            finish=dict(self.result.finish),
        )

    def run(self, agents: Sequence[SimAgent]) -> SimResult:
        """One-shot wrapper: submit ``agents`` and drain (legacy surface)."""
        for a in sorted(agents, key=lambda a: (a.arrival, a.agent_id)):
            self.submit(a)
        return self.drain()
