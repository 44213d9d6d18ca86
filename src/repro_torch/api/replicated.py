"""Multi-replica serving: shard agents across N child backends.

:class:`ReplicatedBackend` implements the :class:`repro.api.Backend`
protocol over a fleet of children (any mix of ``SimBackend`` /
``EngineBackend`` — the children only need the protocol).  Incoming
``AgentSpec`` submissions are placed by a pluggable *router*, all children
advance in lockstep through ``run(until)``, and the per-replica GPS clocks
are reconciled into one global virtual time by a
:class:`repro.core.GlobalVirtualClock` — so Justitia's selective-pampering
order and the worst-case delay bound can be stated fleet-wide, not just per
replica (naive per-replica fair queuing loses global fairness exactly when
the replica clocks drift; the reconciled lag measures that drift).

Routers register with ``@register_router(name)`` the same way schedulers
register with ``@register_scheduler``:

  * ``round_robin`` — placement by submission order, oblivious to load;
  * ``least_loaded`` — fewest live (uncompleted) agents;
  * ``memory_cost_aware`` — smallest outstanding predicted KV token-time
    after adding this agent, normalized by replica capacity (greedy
    balancing on the predictor's memory-centric cost estimate).

Routers are deterministic given the submission sequence (ties break toward
the lowest replica index), which is what makes the engine-vs-sim replicated
equivalence testable: same routing seed => same per-replica assignment.
All routers place over the fleet's LIVE replicas only — after a failover
the registry policies see post-failure occupancy, and ``rebalance`` routes
a dead replica's backlog through the same placement path as fresh
submissions.

Fault tolerance (PR 8).  A :class:`repro.api.faults.FaultPlan` injects
deterministic crash / stall / slowdown windows at ``advance()`` boundaries:
``run(until)`` slices the fleet's advancement at the plan's window edges
(plus the watchdog's probe deadlines) and clamps each child's horizon per
:meth:`FaultPlan.horizon` — child state is never mutated, so the same plan
reproduces the same run bit for bit.  A progress watchdog
(``watchdog_timeout`` seconds, ``watchdog_retries`` backoff-growing
retries) marks a child SUSPECT when it lags a probe by one timeout,
RECOVERED (``ReplicaRecovered``) when it catches back up, and DEAD once it
makes no progress for the whole budget ``timeout * sum(backoff**i)`` —
at which point its uncompleted agents fail over: each is re-submitted to a
surviving replica (remaining stages only — completed stages are never
redone, in-progress stages restart), the global virtual clock carries the
agent's accrued virtual finish time across the migration, and the fleet
emits ``ReplicaFailed`` + per-agent ``AgentRequeued`` events.  With the
watchdog disabled, a crashed child with in-flight work raises
:class:`FleetStalledError` instead of leaving the fleet spinning.

Concurrent advancement + work stealing (PR 10).  ``fleet_workers > 1``
fans each ``_drive`` slice out on a bounded thread pool: engine children
release the GIL inside device compute, sim children are independent
pure-Python cores, and the only serialized sections are the slice barrier
(horizon clamping, watchdog probes, ``GlobalVirtualClock`` bookkeeping)
and the child-major buffer replay that re-emits every child's events in
child-index order — reproducing the sequential loop's global event order
bit for bit (see :class:`_ReplicaChannel`).  ``steal_threshold`` arms
load-triggered work stealing: at every ``steal_interval`` multiple, a
replica whose queued-and-never-admitted backlog (predicted cost normalized
by ``virtual_capacity``) exceeds the threshold times the live-fleet mean
migrates its newest queued agents to underloaded live replicas through the
failover requeue machinery, with accrued virtual time carried by
``GlobalVirtualClock.steal``.  ``retain_agents=False`` (with the
children's ``retain_results=False``) switches the fleet to streaming
emission: per-agent bookkeeping is dropped at completion and ``compact()``
trims the reconciled clock, bounding memory by the live-agent population
instead of the total workload.

Listener callbacks from child k are forwarded in *workload seconds* with a
``replica=k`` keyword, so the service's dispatcher (and the typed events in
``repro.api.events``) know which replica served each lifecycle step.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.api.backend import AgentSpec, Backend, BackendResult
from repro_torch.api.faults import FaultPlan
from repro_torch.core.virtual_time import GlobalClockSnapshot, GlobalVirtualClock

_EPS = 1e-9

# ---------------------------------------------------------------- routers

_ROUTERS: dict[str, type] = {}
_ROUTER_ALIASES: dict[str, str] = {}


def register_router(name: str, *aliases: str):
    """Class decorator: register a :class:`Router` under ``name``.

    Name and aliases must not collide with any existing canonical name or
    alias (same shadowing protection as ``@register_scheduler``).
    """

    def deco(cls):
        for n in (name, *aliases):
            if n in _ROUTERS or n in _ROUTER_ALIASES:
                raise ValueError(f"router name {n!r} already registered")
        cls.name = name
        _ROUTERS[name] = cls
        for alias in aliases:
            _ROUTER_ALIASES[alias] = name
        return cls

    return deco


def router_names() -> list[str]:
    """Canonical router names (aliases excluded), registration order."""
    return list(_ROUTERS)


def resolve_router(name: str) -> type:
    canonical = _ROUTER_ALIASES.get(name, name)
    try:
        return _ROUTERS[canonical]
    except KeyError:
        raise ValueError(
            f"unknown router {name!r} (have: {', '.join(_ROUTERS)})"
        ) from None


class Router:
    """Placement policy: pick a replica for each submitted agent.

    Subclasses read fleet state off the bound backend (live agent counts,
    outstanding predicted cost, per-replica capacities) and must be
    deterministic given the submission sequence and ``seed``.  Placement
    is restricted to the fleet's live replicas (``candidates``); before a
    failure that is every index, so the restriction is invisible to
    healthy fleets.
    """

    name = "base"

    def __init__(self, n_replicas: int, seed: int = 0):
        self.n = int(n_replicas)
        self.rng = np.random.default_rng(seed)
        self._backend: Optional["ReplicatedBackend"] = None

    def bind(self, backend: "ReplicatedBackend") -> None:
        self._backend = backend

    def candidates(self) -> tuple[int, ...]:
        """Live replica indices (all of them when unbound)."""
        if self._backend is None:
            return tuple(range(self.n))
        return self._backend.live_replica_indices

    def pick(self, spec: AgentSpec, agent_id: int, pred_cost: float) -> int:
        raise NotImplementedError

    def rebalance(
        self, queued: Sequence[tuple[AgentSpec, int, float]]
    ) -> list[int]:
        """Place a dead replica's backlog onto survivors.

        Default: route each displaced agent through :meth:`pick`, in the
        order given (the fleet passes original-arrival order), so failover
        and fresh submission share one placement path and load-aware
        policies see the occupancy shift as each victim lands.  Override
        for policies that want to plan the whole batch at once.
        """
        return [
            self.pick(spec, agent_id, cost)
            for spec, agent_id, cost in queued
        ]


@register_router("round_robin", "rr")
class RoundRobinRouter(Router):
    def __init__(self, n_replicas: int, seed: int = 0):
        super().__init__(n_replicas, seed)
        self._next = 0

    def pick(self, spec: AgentSpec, agent_id: int, pred_cost: float) -> int:
        live = self.candidates()
        r = live[self._next % len(live)]
        self._next += 1
        return r


@register_router("least_loaded", "ll")
class LeastLoadedRouter(Router):
    """Fewest live agents *per unit of capacity*.

    A raw live-agent count systematically overloads the small replicas of
    a heterogeneous fleet (a child with half the decode rate drains its
    queue at half the speed, so equal counts are not equal load): the
    count is normalized by each replica's ``virtual_capacity``, with the
    deterministic lowest-index tie-break.  On a homogeneous fleet the
    normalization divides every candidate by the same constant, so
    placements are unchanged.
    """

    def pick(self, spec: AgentSpec, agent_id: int, pred_cost: float) -> int:
        loads = self._backend.live_agents
        caps = self._backend.virtual_capacities
        return min(self.candidates(), key=lambda k: (loads[k] / caps[k], k))


@register_router("memory_cost_aware", "cost_aware", "mca")
class MemoryCostAwareRouter(Router):
    """Greedy balancing of outstanding predicted KV token-time.

    Routes to the replica whose post-placement load-to-capacity ratio is
    smallest — the predictor's memory-centric cost estimate stands in for
    the agent's true KV footprint, exactly as it does for Justitia's
    virtual finish times.
    """

    def pick(self, spec: AgentSpec, agent_id: int, pred_cost: float) -> int:
        costs = self._backend.live_cost
        caps = self._backend.virtual_capacities
        return min(
            self.candidates(),
            key=lambda k: ((costs[k] + pred_cost) / caps[k], k),
        )


# -------------------------------------------------------------- failures


class FleetStalledError(RuntimeError):
    """A replica stopped progressing and no watchdog is armed to fail it.

    Raised by :meth:`ReplicatedBackend.run` instead of leaving the fleet
    spinning toward a horizon a crashed child can never reach.  Carries the
    diagnostic state the watchdog would have acted on: the stalled child's
    index, its last event time, its in-flight count, the drive target, and
    the fleet queue-depth snapshot — live replicas report their in-flight
    counts, already-dead replicas are labeled ``"dead"`` explicitly (their
    stranded queues are not depths the fleet can still drain, so counting
    them as numbers misdiagnosed the backlog).
    """

    def __init__(
        self,
        replica: int,
        last_time: float,
        in_flight: int,
        target: float,
        queue_depths: dict,
    ):
        self.replica = int(replica)
        self.last_time = float(last_time)
        self.in_flight = int(in_flight)
        self.target = float(target)
        self.queue_depths = dict(queue_depths)
        super().__init__(
            f"replica {replica} stalled at t={last_time:.6f} with "
            f"{in_flight} in-flight agent(s) while the fleet drives to "
            f"t={target:.6f} (live queue depths: {queue_depths}); arm "
            f"watchdog_timeout for automatic failover"
        )


# ------------------------------------------------------ replica channel


class _ReplicaChannel:
    """Child k's listener: tags callbacks with ``replica=k``, converts the
    child's native timestamps to workload seconds, and keeps the fleet's
    load accounting current (completions decrement the router's view,
    stage completions feed the failover respec bookkeeping).

    Concurrent advancement (PR 10) puts the channel in *buffering* mode
    for the span of one fleet slice: ``_buf`` is flipped from ``None`` to
    a list before the child is handed to a worker thread, every callback
    then records ``(method, args)`` and returns, and after the barrier the
    fleet replays the buffers **in child-index order** by re-invoking the
    same methods with ``_buf = None`` — which reproduces, event for event,
    the global order the sequential lockstep loop (child 0 fully, then
    child 1, ...) would have produced, so listener streams, fleet
    bookkeeping, and global-clock ``_seq`` assignment are bit-identical.
    Two side effects cannot wait for the replay because the child consults
    their results *before* its ``run()`` returns: closed-loop stage
    advancement (the session must append the next stage ahead of the
    child's stage-exhaustion check — see :meth:`on_stage_complete`) and
    the per-agent token counters that feed it.  Both are thread-confined:
    each agent lives on exactly one replica during a slice, so its counter
    keys are touched by one worker only, and the in-band session call is
    serialized under the fleet's ``_cl_lock``.
    """

    def __init__(self, fleet: "ReplicatedBackend", replica: int):
        self.fleet = fleet
        self.replica = replica
        self._buf: Optional[list] = None

    def _forward(self, event: str, agent_id: int, t: float, *args) -> None:
        listener = self.fleet._listener
        if listener is None:
            return
        fn = getattr(listener, event, None)
        if fn is None:
            return
        tw = self.fleet.children[self.replica].to_workload_time(t)
        fn(agent_id, *args, tw, replica=self.replica)

    def _replay(self) -> None:
        """Flush the slice buffer through the passthrough paths (barrier
        side, main thread): re-invoke each buffered method with ``_buf``
        cleared so fleet bookkeeping and listener forwards run exactly as
        they would have in the sequential loop."""
        buf, self._buf = self._buf, None
        for name, args in buf:
            getattr(self, name)(*args)

    def on_arrival(self, agent_id: int, t: float) -> None:
        if self._buf is not None:
            self._buf.append(("on_arrival", (agent_id, t)))
            return
        fleet = self.fleet
        fleet._arrived.add(agent_id)
        if agent_id in fleet._suppress_arrival:
            # failover re-submission: the agent already announced itself on
            # the dead replica — exactly one AgentArrived per agent
            fleet._suppress_arrival.discard(agent_id)
            return
        self._forward("on_arrival", agent_id, t)

    def on_admit(self, agent_id: int, rid: int, t: float) -> None:
        if self._buf is not None:
            self._buf.append(("on_admit", (agent_id, rid, t)))
            return
        self.fleet._ever_admitted.add(agent_id)
        self._forward("on_admit", agent_id, t, rid)

    def on_swap_out(self, agent_id: int, rid: int, t: float) -> None:
        if self._buf is not None:
            self._buf.append(("on_swap_out", (agent_id, rid, t)))
            return
        self._forward("on_swap_out", agent_id, t, rid)

    def on_swap_in(self, agent_id: int, rid: int, t: float) -> None:
        if self._buf is not None:
            self._buf.append(("on_swap_in", (agent_id, rid, t)))
            return
        self._forward("on_swap_in", agent_id, t, rid)

    def on_token(self, agent_id: int, rid: int, token: int, t: float) -> None:
        if self._buf is not None:
            # counted in-band: an in-band closed-loop stage boundary later
            # in this same slice needs the stage's token count before the
            # replay delivers the events (thread-confined per agent key)
            tok = self.fleet._cl_tokens
            tok[agent_id] = tok.get(agent_id, 0) + 1
            self._buf.append(("on_token", (agent_id, rid, token, t)))
            return
        self._forward("on_token", agent_id, t, rid, token)

    def on_prefix_hit(
        self, agent_id: int, rid: int, cached: int, prefill: int, t: float
    ) -> None:
        if self._buf is not None:
            self._buf.append(
                ("on_prefix_hit", (agent_id, rid, cached, prefill, t))
            )
            return
        self._forward("on_prefix_hit", agent_id, t, rid, cached, prefill)

    def on_admission_deferred(
        self, agent_id: int, rid: int, t: float
    ) -> None:
        if self._buf is not None:
            self._buf.append(("on_admission_deferred", (agent_id, rid, t)))
            return
        self._forward("on_admission_deferred", agent_id, t, rid)

    def on_stage_complete(self, agent_id: int, stage: int, t: float) -> None:
        fleet = self.fleet
        if self._buf is not None:
            spec = fleet._specs.get(agent_id)
            if spec is not None and spec.next_stage is not None:
                # in-band closed-loop advancement: the child checks stage
                # exhaustion the moment this emission returns, so the
                # session must run NOW, on this worker thread, and append
                # the next stage via submit_stage — buffering it to the
                # replay would complete the agent a whole slice early.
                # new_tokens comes from the fleet's in-band counters (the
                # dispatcher's handle counts are stale until the replay).
                tok = fleet._cl_tokens.get(agent_id, 0)
                new = tok - fleet._cl_marks.get(agent_id, 0)
                fleet._cl_marks[agent_id] = tok
                fleet._cl_inband(
                    agent_id, stage, new,
                    fleet.children[self.replica].to_workload_time(t),
                    self.replica,
                )
            self._buf.append(("on_stage_complete", (agent_id, stage, t)))
            return
        done = fleet._stages_done
        done[agent_id] = max(done.get(agent_id, 0), stage + 1)
        self._forward("on_stage_complete", agent_id, t, stage)

    def on_suspend(
        self, agent_id: int, stage: int, until: float, t: float
    ) -> None:
        if self._buf is not None:
            self._buf.append(("on_suspend", (agent_id, stage, until, t)))
            return
        fleet = self.fleet
        child = fleet.children[self.replica]
        until_w = child.to_workload_time(until)
        fleet._suspended[agent_id] = until_w
        if not fleet.think_time_accrual:
            fleet.global_clock.note_suspend(
                self.replica, agent_id, child.to_workload_time(t)
            )
        self._forward("on_suspend", agent_id, t, stage, until_w)

    def on_resume(self, agent_id: int, t: float) -> None:
        if self._buf is not None:
            self._buf.append(("on_resume", (agent_id, t)))
            return
        fleet = self.fleet
        fleet._suspended.pop(agent_id, None)
        if not fleet.think_time_accrual:
            fleet.global_clock.note_resume(
                self.replica, agent_id,
                fleet.children[self.replica].to_workload_time(t),
            )
        self._forward("on_resume", agent_id, t)

    def on_agent_complete(self, agent_id: int, t: float) -> None:
        if self._buf is not None:
            self._buf.append(("on_agent_complete", (agent_id, t)))
            return
        tw = self.fleet.children[self.replica].to_workload_time(t)
        self.fleet._on_child_complete(self.replica, agent_id, tw)
        self._forward("on_agent_complete", agent_id, t)


# ---------------------------------------------------- replicated backend


class ReplicatedBackend:
    """N child backends behind the single-backend protocol (see module doc).

    ``submit`` places each agent on one child via the router; ``run``
    advances every child to the same workload time (slicing at fault
    boundaries when a plan is armed); ``drain`` drains the live children,
    merges their results, and reconciles the per-replica virtual clocks
    (the snapshot lands in ``BackendResult.metrics`` as
    ``global_virtual_time`` / ``virtual_lag`` / ``virtual_times``).
    """

    name = "replicated"

    def __init__(
        self,
        children: Sequence[Backend],
        *,
        router: "str | Router" = "round_robin",
        seed: int = 0,
        fault_plan: Optional[FaultPlan] = None,
        watchdog_timeout: Optional[float] = None,
        watchdog_retries: int = 3,
        watchdog_backoff: float = 2.0,
        think_time_accrual: bool = True,
        fleet_workers: Optional[int] = None,
        steal_threshold: Optional[float] = None,
        steal_interval: float = 1.0,
        retain_agents: bool = True,
    ):
        self.children: list[Backend] = list(children)
        if not self.children:
            raise ValueError("need at least one child backend")
        if isinstance(router, str):
            router = resolve_router(router)(len(self.children), seed)
        elif router.n != len(self.children):
            raise ValueError(
                f"router sized for {router.n} replicas, have "
                f"{len(self.children)}"
            )
        self.router = router
        self.router.bind(self)
        self.virtual_capacities = [c.virtual_capacity for c in self.children]
        self.global_clock = GlobalVirtualClock(self.virtual_capacities)
        self.assignment: dict[int, int] = {}     # agent_id -> replica
        self.live_agents = [0] * len(self.children)
        self.live_cost = [0.0] * len(self.children)
        self._pred_cost: dict[int, float] = {}
        self._listener: Any = None
        self._last_snapshot: Optional[GlobalClockSnapshot] = None
        # --- fault injection + watchdog (see module doc) ----------------
        if fault_plan is not None:
            for f in fault_plan.faults:
                if f.replica >= len(self.children):
                    raise ValueError(
                        f"fault plan targets replica {f.replica} of "
                        f"{len(self.children)}"
                    )
        self._plan = fault_plan
        if watchdog_timeout is not None:
            if watchdog_timeout <= 0:
                raise ValueError("watchdog_timeout must be positive")
            if watchdog_retries < 0:
                raise ValueError("watchdog_retries must be >= 0")
            if watchdog_backoff < 1.0:
                raise ValueError("watchdog_backoff must be >= 1")
        self._wd_timeout = watchdog_timeout
        self._wd_retries = int(watchdog_retries)
        self._wd_backoff = float(watchdog_backoff)
        # probe offsets after a window edge: timeout, then retries
        # backoff-growing intervals; the last offset is the death budget
        if watchdog_timeout is not None:
            offs, acc = [], 0.0
            for i in range(self._wd_retries + 1):
                acc += watchdog_timeout * self._wd_backoff**i
                offs.append(acc)
            self._wd_offsets = tuple(offs)
            self._wd_budget = offs[-1]
        else:
            self._wd_offsets = ()
            self._wd_budget = 0.0
        self._dead: set[int] = set()
        self._suspect: set[int] = set()
        self._wd_last: dict[int, float] = {}
        self._failures: list[tuple[int, float]] = []   # (replica, t)
        # --- failover bookkeeping ---------------------------------------
        self._specs: dict[int, AgentSpec] = {}
        self._arrival0: dict[int, float] = {}          # first-submit arrival
        self._extras: dict[int, list] = {}             # appended stages
        self._stages_done: dict[int, int] = {}         # since last (re)submit
        self._stage_base: dict[int, int] = {}          # done before requeue
        self._completed: set[int] = set()
        self._fleet_finish: dict[int, tuple[float, int]] = {}
        self._arrived: set[int] = set()
        self._suppress_arrival: set[int] = set()
        self._requeued: set[int] = set()
        # --- suspension (PR 9) ------------------------------------------
        # ``think_time_accrual`` picks the fleet's GPS stance on tool-call
        # think time: True (Justitia) keeps a suspended agent in its
        # replica's GPS reference, so think time accrues virtual time and
        # its F_j ordering is untouched; False (the Equinox stance) pulls
        # it out via VirtualClock.deactivate — V speeds up for the agents
        # still decoding and the thinker accrues nothing while idle.
        self.think_time_accrual = bool(think_time_accrual)
        self._suspended: dict[int, float] = {}   # agent_id -> until (s)
        # --- concurrent advancement + work stealing (PR 10) -------------
        # fleet_workers > 1 turns each _drive slice into a bounded
        # thread-pool fan-out with child-major buffer replay (see
        # _ReplicaChannel); None/0/1 keeps the frozen sequential loop.
        if fleet_workers is not None and fleet_workers < 0:
            raise ValueError("fleet_workers must be >= 0")
        self._n_workers = min(
            int(fleet_workers or 1), len(self.children)
        ) or 1
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_finalizer = None
        # load-triggered work stealing: armed when steal_threshold is set
        # (> 1 — it multiplies the fleet-mean normalized backlog; the gap
        # between trigger and the stop-at-mean drain is the hysteresis
        # band that prevents migration thrash)
        if steal_threshold is not None and steal_threshold <= 1.0:
            raise ValueError("steal_threshold must be > 1")
        if steal_interval <= 0.0:
            raise ValueError("steal_interval must be positive")
        self.steal_threshold = (
            None if steal_threshold is None else float(steal_threshold)
        )
        self.steal_interval = float(steal_interval)
        self._ever_admitted: set[int] = set()
        self._stolen: set[int] = set()
        self._steals: list[tuple[int, int, int, float]] = []
        # in-band closed-loop plumbing (concurrent slices only)
        self._cl_lock = threading.Lock()
        self._cl_tokens: dict[int, int] = {}
        self._cl_marks: dict[int, int] = {}
        # streaming mode: retain_agents=False drops per-agent fleet
        # bookkeeping at completion and queues the finish times for
        # compact(), trading per-agent results for O(live) memory
        self.retain_agents = bool(retain_agents)
        self._compact_done: list[tuple[float, int]] = []
        self._channels: list[_ReplicaChannel] = [
            _ReplicaChannel(self, idx)
            for idx in range(len(self.children))
        ]
        for child, chan in zip(self.children, self._channels):
            child.set_listener(chan)

    # --------------------------------------------------------- protocol

    @property
    def now(self) -> float:
        return max(
            c.now
            for k, c in enumerate(self.children)
            if k not in self._dead
        )

    @property
    def virtual_capacity(self) -> float:
        return float(sum(self.virtual_capacities))

    @property
    def n_replicas(self) -> int:
        return len(self.children)

    @property
    def live_replica_indices(self) -> tuple[int, ...]:
        return tuple(
            k for k in range(len(self.children)) if k not in self._dead
        )

    @property
    def dead_replica_indices(self) -> tuple[int, ...]:
        return tuple(sorted(self._dead))

    def set_listener(self, listener: Any) -> None:
        """Install the fleet listener.

        Callbacks arrive in workload seconds with a ``replica=k`` keyword
        identifying the serving child (the channels convert each child's
        native clock before forwarding), so ``to_workload_time`` is the
        identity here.  Fleet-scoped events (``on_replica_failed`` /
        ``on_replica_recovered``) use ``agent_id=-1``.
        """
        self._listener = listener

    def to_workload_time(self, t: float) -> float:
        return float(t)

    def _notify(self, event: str, agent_id: int, *args,
                t: float, replica: int) -> None:
        """Fleet-originated listener callback (already workload seconds)."""
        listener = self._listener
        if listener is None:
            return
        fn = getattr(listener, event, None)
        if fn is not None:
            fn(agent_id, *args, float(t), replica=replica)

    def submit(self, spec: AgentSpec, agent_id: int) -> float:
        pred, _ = spec.resolved_costs()
        replica = self.router.pick(spec, agent_id, pred)
        if not 0 <= replica < len(self.children):
            raise ValueError(
                f"router {self.router.name!r} picked replica {replica} "
                f"of {len(self.children)}"
            )
        if replica in self._dead:
            raise ValueError(
                f"router {self.router.name!r} picked dead replica {replica}"
            )
        arrival = self.children[replica].submit(spec, agent_id)
        self.assignment[agent_id] = replica
        self.live_agents[replica] += 1
        self.live_cost[replica] += pred
        self._pred_cost[agent_id] = pred
        self._specs[agent_id] = spec
        self._arrival0[agent_id] = arrival
        self.global_clock.register(replica, agent_id, arrival, pred)
        return arrival

    def submit_stage(self, agent_id: int, specs, **kw) -> None:
        """Route a closed-loop follow-up stage to the agent's replica.

        ``**kw`` forwards the optional prefix-cache metadata
        (``prompt_ids``/``hints``) untouched — each child scales it to
        its own granularity.  The stage is also recorded fleet-side so a
        later failover can re-submit the agent's full remaining work.
        """
        try:
            replica = self.assignment[agent_id]
        except KeyError:
            raise ValueError(
                f"agent {agent_id} was never placed on this fleet"
            ) from None
        self._extras.setdefault(agent_id, []).append(
            (list(specs), kw.get("prompt_ids"), kw.get("hints"))
        )
        self.children[replica].submit_stage(agent_id, specs, **kw)

    def run(self, until: float) -> None:
        """Advance the whole fleet in lockstep to ``until`` (seconds).

        Without a fault plan, work stealing, or a worker pool this is the
        plain lockstep loop (bit-identical to the pre-fault-tolerance
        fleet).  Otherwise advancement goes through :meth:`_drive`, sliced
        at the plan's window edges, the watchdog's probe deadlines, and
        the steal-interval multiples — the slice targets depend only on
        the plan/steal configuration, never on ``fleet_workers``, which is
        what lets the concurrency property tests demand bit-identity
        between the sequential and the pooled stepper on the same plan.
        """
        if (
            self._plan is not None
            or self.steal_threshold is not None
            or self._n_workers > 1
        ):
            self._drive(float(until))
            return
        for k, child in enumerate(self.children):
            if k not in self._dead:
                child.run(until)

    # ------------------------------------------------------- sliced drive

    def _drive(self, until: float) -> None:
        start = self.now
        if until <= start + _EPS:
            return
        cand: set[float] = set()
        if self._plan is not None:
            for b in self._plan.boundaries():
                cand.add(b)
                for off in self._wd_offsets:
                    cand.add(b + off)
        if self.steal_threshold is not None:
            # integer multiples of the steal interval (no accumulating
            # float steps): the serialized points where backlog imbalance
            # is measured and queued agents may migrate
            step = self.steal_interval
            i = int(math.floor((start + _EPS) / step)) + 1
            while i * step < until - _EPS:
                if i * step > start + _EPS:
                    cand.add(i * step)
                i += 1
        targets = sorted(t for t in cand if start + _EPS < t < until - _EPS)
        targets.append(until)
        for s in targets:
            self._advance_slice(s)
            if self._plan is not None:
                self._watch(s)
            if self.steal_threshold is not None:
                self._steal(s)

    def _advance_slice(self, s: float) -> None:
        """Step every live child to its (fault-clamped) horizon for one
        slice ending at fleet time ``s``.

        Sequential mode steps children in index order on the caller's
        thread.  Concurrent mode flips every stepped child's channel into
        buffering, fans the ``run`` calls out on the worker pool (the only
        shared state a child touches mid-slice is thread-confined or
        ``_cl_lock``-serialized — see :class:`_ReplicaChannel`), joins
        them all (the reconcile barrier), then replays the buffers in
        child-index order, which reproduces the sequential loop's global
        event order exactly.  A child that raises still has its buffer
        replayed (its pre-fault events are real); the lowest-index error
        is then re-raised.
        """
        horizons: list[tuple[int, float]] = []
        for k in self.live_replica_indices:
            child = self.children[k]
            h = s if self._plan is None else min(s, self._plan.horizon(k, s))
            if h > child.now + _EPS:
                horizons.append((k, h))
        if not horizons:
            return
        if self._n_workers <= 1:
            for k, h in horizons:
                self.children[k].run(h)
            return
        for k, _ in horizons:
            self._channels[k]._buf = []
        pool = self._ensure_pool()
        futures = [
            (k, pool.submit(self.children[k].run, h)) for k, h in horizons
        ]
        errors: list[tuple[int, BaseException]] = []
        for k, fut in futures:
            try:
                fut.result()
            except BaseException as exc:  # noqa: BLE001 — rethrown below
                errors.append((k, exc))
        for k, _ in horizons:
            self._channels[k]._replay()
        if errors:
            raise errors[0][1]

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._n_workers,
                thread_name_prefix="fleet-child",
            )
            # bound method keeps the executor (not self) alive until the
            # fleet is collected without an explicit close()
            self._pool_finalizer = weakref.finalize(
                self, self._pool.shutdown, wait=False
            )
        return self._pool

    def close(self) -> None:
        """Shut the worker pool down (idempotent; the fleet stays usable —
        the next concurrent slice lazily recreates the pool)."""
        if self._pool is not None:
            if self._pool_finalizer is not None:
                self._pool_finalizer.detach()
                self._pool_finalizer = None
            self._pool.shutdown(wait=True)
            self._pool = None

    # ---------------------------------------------------- work stealing

    def _steal(self, s: float) -> None:
        """One load-triggered stealing pass at fleet time ``s`` (serialized,
        after the slice barrier and any watchdog verdicts).

        Backlog load of replica k = Σ predicted cost of its *eligible*
        agents / ``virtual_capacity[k]``; eligible means arrived, never
        admitted, not completed, not suspended — an admitted agent has KV
        state worth locality, a suspended one is mid-think with retained
        state, and a not-yet-arrived one is invisible backlog, so only
        cold queued work ever migrates.  A replica whose load exceeds
        ``steal_threshold`` x the live-fleet mean sheds its newest-arrived
        victims (LIFO keeps FIFO service order intact for the head of the
        queue) onto underloaded live, non-suspect replicas until it drains
        back to the mean — the threshold→mean gap is the hysteresis band.
        The mean is fixed for the pass; per-replica loads update as each
        victim lands so one pass cannot overshoot a target.  The child's
        ``cancel`` is the authoritative eligibility gate: anything it
        refuses (raced into admission inside the slice) is skipped.
        """
        thr = self.steal_threshold
        live = [k for k in self.live_replica_indices if k not in self._suspect]
        if len(live) < 2:
            return
        eligible: dict[int, list[int]] = {k: [] for k in live}
        for aid, k in self.assignment.items():
            if (
                k in eligible
                and aid in self._arrived
                and aid not in self._ever_admitted
                and aid not in self._completed
                and aid not in self._suspended
            ):
                eligible[k].append(aid)
        load = {
            k: sum(self._pred_cost.get(a, 0.0) for a in eligible[k])
            / self.virtual_capacities[k]
            for k in live
        }
        mean = sum(load.values()) / len(live)
        if mean <= _EPS:
            return
        for k in live:
            if load[k] <= thr * mean + _EPS:
                continue
            victims = sorted(
                eligible[k],
                key=lambda a: (-self._arrival0.get(a, 0.0), -a),
            )
            for aid in victims:
                if load[k] <= mean + _EPS:
                    break
                targets = [
                    j for j in live if j != k and load[j] < mean - _EPS
                ]
                if not targets:
                    break
                j = min(targets, key=lambda x: (load[x], x))
                old_cost = self._pred_cost.get(aid, 0.0)
                # anti-thrash guard: the move must strictly shrink the
                # pairwise max — when the tail holds too few queued agents
                # to balance, "drain to the mean" alone ping-pongs the
                # same victims between replicas every interval
                new_k = load[k] - old_cost / self.virtual_capacities[k]
                new_j = load[j] + old_cost / self.virtual_capacities[j]
                if max(new_k, new_j) >= load[k] - _EPS:
                    continue
                if not self.children[k].cancel(aid):
                    continue
                spec = self._respec(aid, s)
                if spec is None:  # pragma: no cover — never-admitted ⇒ work
                    continue
                cost = spec.resolved_costs()[0]
                self.live_agents[k] -= 1
                self.live_cost[k] -= old_cost
                self._stage_base[aid] = self._stage_base.get(
                    aid, 0
                ) + self._stages_done.pop(aid, 0)
                self._extras.pop(aid, None)
                self._specs[aid] = spec
                self._suppress_arrival.add(aid)
                arrival = self.children[j].submit(spec, aid)
                self.assignment[aid] = j
                self.live_agents[j] += 1
                self.live_cost[j] += cost
                self._pred_cost[aid] = cost
                self.global_clock.steal(aid, k, j, arrival, cost)
                self._requeued.add(aid)
                self._stolen.add(aid)
                self._steals.append((aid, k, j, float(max(arrival, s))))
                self._notify(
                    "on_requeued", aid, k, t=max(arrival, s), replica=j
                )
                load[k] -= old_cost / self.virtual_capacities[k]
                load[j] += cost / self.virtual_capacities[j]

    # ------------------------------------------------ closed-loop in-band

    def _cl_inband(
        self, agent_id: int, stage: int, new_tokens: int, t: float,
        replica: int,
    ) -> None:
        """Run a closed-loop agent's session in-band during a concurrent
        slice (called from the serving child's worker thread — see
        :meth:`_ReplicaChannel.on_stage_complete`).  Serialized under
        ``_cl_lock``; the listener's ``on_closed_loop_stage`` runs the
        session and appends the next stage, and later suppresses its own
        replayed ``on_stage_complete`` advancement so the session fires
        exactly once per logical stage."""
        listener = self._listener
        if listener is None:
            return
        fn = getattr(listener, "on_closed_loop_stage", None)
        if fn is None:
            raise RuntimeError(
                "concurrent fleet advancement requires the listener to "
                "implement on_closed_loop_stage for closed-loop agents: "
                "the session must run inside the serving child's emission "
                "(before its stage-exhaustion check), not at buffer "
                "replay — drive closed-loop work through AgentService, or "
                "add the hook to the listener"
            )
        with self._cl_lock:
            fn(agent_id, stage, new_tokens, t, replica=replica)

    def _watch(self, s: float) -> None:
        """One watchdog pass at fleet time ``s`` (after driving children).

        A live, busy child lagging the slice target by one timeout turns
        SUSPECT; a suspect that catches back up emits ``ReplicaRecovered``;
        a suspect that made no progress since the previous probe and lags
        by the full budget is declared DEAD and failed over.  With the
        watchdog disabled, a crashed-and-busy child raises
        :class:`FleetStalledError` instead (stall guard).
        """
        deaths: list[int] = []
        for k in self.live_replica_indices:
            child = self.children[k]
            now_k = child.now
            lag = s - now_k
            busy = getattr(child, "in_flight", 0) > 0
            if self._wd_timeout is None:
                if busy and lag > _EPS and self._plan.crash_time(k) <= s:
                    raise FleetStalledError(
                        k, now_k, child.in_flight, s, self._queue_depths()
                    )
                continue
            last = self._wd_last.get(k)
            progressed = last is None or now_k > last + _EPS
            self._wd_last[k] = now_k
            if busy and lag > _EPS:
                if (
                    k in self._suspect
                    and not progressed
                    and lag >= self._wd_budget - _EPS
                ):
                    deaths.append(k)
                elif lag >= self._wd_timeout - _EPS:
                    self._suspect.add(k)
            elif k in self._suspect and lag <= _EPS:
                self._suspect.discard(k)
                self._notify("on_replica_recovered", -1, t=s, replica=k)
        for k in deaths:
            self._fail_replica(k, s)

    def _queue_depths(self) -> dict:
        """Diagnostic fleet snapshot: live replicas map to their in-flight
        counts; dead replicas map to the literal ``"dead"`` so a stranded
        queue is never mistaken for drainable backlog."""
        depths: dict = {
            j: getattr(self.children[j], "in_flight", 0)
            for j in self.live_replica_indices
        }
        for j in self.dead_replica_indices:
            depths[j] = "dead"
        return depths

    # --------------------------------------------------------- failover

    def _respec(self, agent_id: int, t: float) -> Optional[AgentSpec]:
        """The agent's remaining work as a fresh :class:`AgentSpec`.

        Completed stages (original + closed-loop appendments) are dropped;
        the in-progress stage restarts from its beginning (stage-granularity
        retry — per-stage completion callbacks therefore still fire exactly
        once per logical stage).  Per-stage metadata rides along when it can
        be aligned with the surviving stages and is dropped otherwise
        (prompts are then re-synthesized by the target child).  Returns
        ``None`` when nothing remains.
        """
        spec = self._specs[agent_id]
        extras = self._extras.get(agent_id, [])
        stages = [list(st) for st in spec.stages]
        stages += [list(sp) for sp, _, _ in extras]
        done = self._stage_base.get(agent_id, 0) + self._stages_done.get(
            agent_id, 0
        )
        if done >= len(stages):
            return None
        remaining = stages[done:]

        def aligned(base, idx):
            if spec.stages and base is None:
                return None
            if any(e[idx] is None for e in extras):
                return None
            merged = list(base or []) + [list(e[idx]) for e in extras]
            return merged[done:]

        prompt_ids = aligned(spec.prompt_ids, 1)
        hints = aligned(spec.cached_hints, 2)
        prompts = None
        if spec.prompts is not None and not extras:
            prompts = [list(p) for p in spec.prompts][done:]
        return dataclasses.replace(
            spec,
            stages=remaining,
            arrival=max(float(t), self._arrival0.get(agent_id, 0.0)),
            prompts=prompts,
            prompt_ids=prompt_ids,
            cached_hints=hints,
        )

    def _fail_replica(self, k: int, t: float) -> None:
        """Declare child ``k`` DEAD at fleet time ``t`` and fail over.

        The dead child is excluded from every future advance/drain (its
        internal queue still holds the victims, but it is never driven
        again); each uncompleted agent assigned to it is re-specced to its
        remaining stages and re-submitted to a survivor chosen by
        ``router.rebalance``, carrying its accrued virtual time across the
        migration.  Emits one fleet-scoped ``ReplicaFailed`` plus one
        ``AgentRequeued`` per already-arrived victim (never-arrived agents
        are re-placed silently — their single ``AgentArrived`` fires on the
        survivor).
        """
        child = self.children[k]
        self._dead.add(k)
        self._suspect.discard(k)
        if len(self._dead) >= len(self.children):
            raise RuntimeError(
                f"replica {k} failed at t={t:.6f} and no live replica "
                f"remains to fail over to"
            )
        self._failures.append((k, float(t)))
        reason = (
            f"no progress past t={child.now:.6f} for the watchdog budget "
            f"({self._wd_budget:.4f}s)"
        )
        self._notify("on_replica_failed", -1, reason, t=t, replica=k)
        self.global_clock.fail_replica(k)
        victims = sorted(
            (
                aid
                for aid, r in self.assignment.items()
                if r == k and aid not in self._completed
            ),
            key=lambda aid: (self._arrival0.get(aid, 0.0), aid),
        )
        queued = []
        for aid in victims:
            spec = self._respec(aid, t)
            self.live_agents[k] -= 1
            self.live_cost[k] -= self._pred_cost.get(aid, 0.0)
            if spec is None:
                continue
            until_s = self._suspended.get(aid)
            if until_s is not None and until_s > spec.arrival:
                # a suspended victim keeps thinking through the failover:
                # its remaining work may not start before the think time
                # elapses, so the survivor sees a correspondingly later
                # arrival (the tool call itself survives the crash — only
                # the serving replica died)
                spec = dataclasses.replace(spec, arrival=float(until_s))
            queued.append((spec, aid, spec.resolved_costs()[0]))
        placements = self.router.rebalance(queued)
        for (spec, aid, cost), r in zip(queued, placements):
            if r in self._dead or not 0 <= r < len(self.children):
                raise ValueError(
                    f"router {self.router.name!r} rebalanced agent {aid} "
                    f"onto unusable replica {r}"
                )
            # reset the stage cursor: the survivor re-indexes the trimmed
            # spec's stages from 0
            self._stage_base[aid] = self._stage_base.get(
                aid, 0
            ) + self._stages_done.pop(aid, 0)
            self._extras.pop(aid, None)
            self._specs[aid] = spec
            if aid in self._arrived:
                self._suppress_arrival.add(aid)
            arrival = self.children[r].submit(spec, aid)
            self.assignment[aid] = r
            self.live_agents[r] += 1
            self.live_cost[r] += cost
            self._pred_cost[aid] = cost
            self.global_clock.migrate(aid, r, arrival, cost)
            if aid in self._arrived:
                # a suspended victim's open suspension closes HERE, on the
                # dead replica, exactly once — the survivor serves the
                # re-specced remainder as a fresh submission and will not
                # re-emit the resume
                if self._suspended.pop(aid, None) is not None:
                    self._notify(
                        "on_resume", aid, t=max(arrival, t), replica=k
                    )
                self._requeued.add(aid)
                self._notify(
                    "on_requeued", aid, k, t=max(arrival, t), replica=r
                )
            else:
                self._suspended.pop(aid, None)

    # ------------------------------------------------------------ drain

    def drain(self) -> BackendResult:
        # flush past every planned fault (plus the watchdog budget) first,
        # so failures scheduled after the last submission still trigger
        # detection and failover before results are collected; without a
        # watchdog the flush still overshoots the last edge so the stall
        # guard can observe a crashed-and-busy child (draining it blind
        # would serve agents the crash should have stranded)
        if self._plan is not None:
            margin = self._wd_budget if self._wd_timeout is not None else 1e-3
            flush = self._plan.max_boundary() + margin
            if flush > self.now + _EPS:
                self.run(flush)
        finish: dict[int, float] = {}
        jct: dict[int, float] = {}
        per_replica: list[dict] = []
        swaps = decisions = 0
        sched_time = 0.0
        makespan = 0.0
        # fleet-level prefix-cache metrics, aggregated exactly like jct:
        # hit_fractions dict-merge (agent ids are fleet-unique — the
        # service assigns them before routing), prefill_tokens_saved
        # summed (children report backend-native token scales)
        hit_fractions: dict[int, float] = {}
        prefill_tokens_saved = 0
        admission_deferrals = 0
        suspensions = resumes = suspend_spills = 0
        held_peak = 0.0
        for idx, child in enumerate(self.children):
            if idx in self._dead:
                # never driven again: harvest its pre-failure completions
                # from the fleet-side records instead of draining it (a
                # drain would re-serve the migrated victims it still holds)
                per_replica.append(
                    {
                        "backend": child.name,
                        "dead": True,
                        "agents": sum(
                            1
                            for _, r in self._fleet_finish.values()
                            if r == idx
                        ),
                        "makespan": child.now,
                        "swaps": 0,
                    }
                )
                continue
            res = child.drain()
            finish.update(res.finish)
            jct.update(res.jct)
            swaps += res.swaps
            decisions += res.sched_decisions
            sched_time += res.sched_time
            makespan = max(makespan, res.makespan)
            hit_fractions.update(res.metrics.get("hit_fractions") or {})
            prefill_tokens_saved += res.metrics.get(
                "prefill_tokens_saved", 0
            ) or 0
            admission_deferrals += res.metrics.get(
                "admission_deferrals", 0
            ) or 0
            suspensions += res.metrics.get("suspensions", 0) or 0
            resumes += res.metrics.get("resumes", 0) or 0
            suspend_spills += res.metrics.get("suspend_spills", 0) or 0
            held_peak = max(
                held_peak, res.metrics.get("held_peak", 0.0) or 0.0
            )
            per_replica.append(
                {
                    "backend": child.name,
                    "agents": len(res.finish),
                    "makespan": res.makespan,
                    "swaps": res.swaps,
                    **{f"child_{k}": v for k, v in res.metrics.items()},
                }
            )
        # completions that happened on a replica before it died
        for aid, (tw, _r) in self._fleet_finish.items():
            if aid not in finish:
                finish[aid] = tw
                jct[aid] = tw - self._arrival0.get(aid, tw)
        # a migrated agent's JCT spans from its ORIGINAL arrival — the
        # survivor only saw the re-submission
        for aid in self._requeued:
            if aid in finish:
                jct[aid] = finish[aid] - self._arrival0.get(aid, finish[aid])
        # resume lockstep: drained children sit at their own makespans, so
        # re-anchor every live child at the fleet makespan — later
        # submissions then clamp to a common clock and can never predate
        # the reconciled horizon (submit/drain may interleave freely)
        makespan = max(makespan, self.now)
        for k in self.live_replica_indices:
            self.children[k].run(makespan)
        snap = self.global_clock.reconcile(makespan)
        self._last_snapshot = snap
        return BackendResult(
            finish=finish,
            jct=jct,
            makespan=makespan,
            swaps=swaps,
            sched_decisions=decisions,
            sched_time=sched_time,
            metrics={
                "replicas": len(self.children),
                "live_replicas": len(self.live_replica_indices),
                "router": self.router.name,
                "per_replica": per_replica,
                "global_virtual_time": snap.global_virtual_time,
                "virtual_lag": snap.lag,
                "virtual_times": list(snap.virtual_times),
                "hit_fractions": hit_fractions,
                "prefill_tokens_saved": prefill_tokens_saved,
                "admission_deferrals": admission_deferrals,
                "replica_failures": len(self._failures),
                "failed_replicas": sorted(self._dead),
                "agents_requeued": len(self._requeued),
                "fleet_workers": self._n_workers,
                "agents_stolen": len(self._stolen),
                "steals": len(self._steals),
                "suspensions": suspensions,
                "resumes": resumes,
                "suspend_spills": suspend_spills,
                "held_peak": held_peak,
                "think_time_accrual": self.think_time_accrual,
            },
        )

    # ------------------------------------------------------- fleet state

    def _on_child_complete(
        self, replica: int, agent_id: int, t: Optional[float] = None
    ) -> None:
        self.live_agents[replica] -= 1
        self.live_cost[replica] -= self._pred_cost.pop(agent_id, 0.0)
        if self.retain_agents:
            self._completed.add(agent_id)
            if t is not None:
                self._fleet_finish[agent_id] = (float(t), replica)
            return
        # streaming mode: drop every per-agent map at completion — the
        # assignment pop is what keeps _steal/_fail_replica correct
        # without the O(agents) _completed set, and the finish time is
        # queued so compact() can forget the clock entry once the arrival
        # is safely reconciled (forgetting earlier would let the replayed
        # arrival resurrect the virtual finish)
        if t is not None and self._plan is not None:
            self._fleet_finish[agent_id] = (float(t), replica)
        self.assignment.pop(agent_id, None)
        self._specs.pop(agent_id, None)
        self._extras.pop(agent_id, None)
        self._stages_done.pop(agent_id, None)
        self._stage_base.pop(agent_id, None)
        self._arrival0.pop(agent_id, None)
        self._arrived.discard(agent_id)
        self._suppress_arrival.discard(agent_id)
        self._ever_admitted.discard(agent_id)
        self._stolen.discard(agent_id)
        self._requeued.discard(agent_id)
        self._suspended.pop(agent_id, None)
        self._cl_tokens.pop(agent_id, None)
        self._cl_marks.pop(agent_id, None)
        if t is not None:
            self._compact_done.append((float(t), agent_id))

    def compact(self, until: float) -> GlobalClockSnapshot:
        """Streaming-mode checkpoint: reconcile the global clock to
        ``until`` and forget clock bookkeeping for agents that completed
        at or before the reconciled horizon.

        Safe because reconcile replays every pending arrival up to
        ``until`` first — a forgotten agent's arrival can no longer be
        sitting in the pending heap waiting to re-create its virtual
        finish entry.  With ``retain_agents=True`` this is just an
        explicit reconcile."""
        snap = self.global_clock.reconcile(float(until))
        self._last_snapshot = snap
        if not self.retain_agents:
            keep: list[tuple[float, int]] = []
            for t, aid in self._compact_done:
                if t <= until + _EPS:
                    self.global_clock.forget(aid)
                else:
                    keep.append((t, aid))
            self._compact_done = keep
        return snap

    def pampering_order(self) -> list[int]:
        """Fleet-wide selective-pampering order (reconciled F_j ascending).

        Only agents whose arrivals have been reconciled (i.e. swept by
        ``drain`` or an explicit ``global_clock.reconcile``) appear.
        """
        return self.global_clock.pampering_order()

    def delay_bound(
        self, c_max: float, c_agent_max: float, service_rate: float = 1.0
    ) -> float:
        """Fleet-wide Theorem B.1 bound over the LIVE replicas.

        Delegates to :meth:`GlobalVirtualClock.delay_bound` — after a
        failover the bound is re-derived for the degraded fleet (dead
        capacities excluded), so it stays a valid worst-case statement for
        the replicas that are actually serving.
        """
        return self.global_clock.delay_bound(
            c_max, c_agent_max, service_rate
        )
