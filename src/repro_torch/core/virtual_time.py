"""GPS virtual time for fair queuing (paper §4.3, Eq. 2-3).

V(0) = 0 ;  dV/dt = M / N_t

where M is the total KV-cache space (in KV-token units) and N_t the number
of agents *active in the GPS reference system* at real time t.  V advances
at the marginal per-agent GPS service rate, so an agent arriving at a_j with
cost C_j finishes in GPS exactly when V reaches

    F_j = V(a_j) + C_j            (virtual finish time; Eq. 3)

F_j is computed once at arrival and never updated: later arrivals slow the
*real-time* mapping of V but never reorder {F_j} — that is the one-shot
property the paper borrows from WFQ (Demers et al. 1989; Parekh & Gallager
1993).

The clock is event-driven: ``advance(t)`` integrates V piecewise-linearly
from the last update to t, popping GPS completions (which change N_t) from a
min-heap of pending virtual finish times as V sweeps past them.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence


class VirtualClock:
    """Piecewise-linear integrator of the GPS virtual time."""

    def __init__(self, total_kv: float):
        if total_kv <= 0:
            raise ValueError("total_kv must be positive")
        self.m = float(total_kv)
        self._v = 0.0          # current virtual time
        self._t = 0.0          # real time of last update
        self._finish_heap: list[tuple[float, int]] = []  # (F_j, agent_id)
        self._active: set[int] = set()
        self._retired: set[int] = set()   # swept past their F_j

    # -- inspection ---------------------------------------------------------

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def value(self) -> float:
        """V at the last update time (no simulation; pairs with ``now``)."""
        return self._v

    def now(self, t: float) -> float:
        """V(t) without mutating state (t must be >= last update time).

        O(1) when the clock is already advanced to ``t`` — the common case
        after ``GlobalVirtualClock.reconcile`` sweeps every replica clock to
        the same horizon — and a copy-based simulation only for genuinely
        future peeks.
        """
        if t <= self._t:
            return self._v
        v, _ = self._simulate(t, list(self._finish_heap))
        return v

    # -- core ---------------------------------------------------------------

    def advance(self, t: float) -> None:
        """Integrate V up to real time t, retiring GPS completions.

        Destructive integration directly against the live heap — each
        retirement is one O(log n) pop, so sweeping the clock across k
        completions costs O(k log n) rather than the full-heap copy the
        peek-then-repop implementation paid on every call.
        """
        if t < self._t - 1e-9:
            raise ValueError(f"clock moved backwards: {t} < {self._t}")
        if t <= self._t:
            return
        v, retired = self._simulate(t, self._finish_heap)
        for agent_id in retired:
            self._active.discard(agent_id)
            self._retired.add(agent_id)
        self._v, self._t = v, t

    def on_arrival(self, agent_id: int, t: float, cost: float) -> float:
        """Register agent arrival; returns its virtual finish time F_j."""
        self.advance(t)
        f = self._v + float(cost)
        self._active.add(agent_id)
        heapq.heappush(self._finish_heap, (f, agent_id))
        return f

    def deactivate(self, agent_id: int, t: float) -> None:
        """Remove an agent from the GPS reference at real time ``t``.

        Think-time semantics with accrual DISABLED (the Equinox stance —
        see ``ReplicatedBackend(think_time_accrual=False)``): a suspended
        agent stops drawing GPS service, so V speeds up for the agents
        still active and the thinker accrues no virtual time while idle.
        Its F_j stays on the heap (one-shot property untouched); while
        inactive a sweep past F_j does not change the service rate.
        No-op if the agent is not currently active.
        """
        self.advance(t)
        self._active.discard(agent_id)

    def reactivate(self, agent_id: int, t: float) -> None:
        """Re-enter the GPS reference after think time (pairs with
        :meth:`deactivate`).  An agent whose F_j was already swept while
        it was inactive stays retired — re-adding it would suppress the
        clock rate forever, since its heap entry is gone."""
        self.advance(t)
        if agent_id not in self._retired:
            self._active.add(agent_id)

    def forget(self, agent_id: int) -> None:
        """Drop a finished agent's membership bookkeeping (streaming mode).

        The retired set otherwise grows O(agents) over a clock's lifetime —
        it exists only to block ``reactivate`` of an already-swept agent,
        which cannot happen once the agent has left the system for good.
        Never call this for an agent that may still suspend/resume.
        """
        self._retired.discard(agent_id)
        self._active.discard(agent_id)

    # -- internals ----------------------------------------------------------

    def _simulate(self, t: float, heap: list) -> tuple[float, list[int]]:
        """Integrate from (self._t, self._v) to real time t against ``heap``.

        Returns (V(t), agents whose GPS finish V is swept past), popping
        retirements off ``heap`` (pass the live heap to mutate, a copy to
        peek).  While N_t agents are active, dV/dt = M / N_t; when no agent
        is active V stalls (no service is being dealt in GPS — matching the
        convention that V only needs to order *backlogged* periods; an idle
        system re-anchors at the current V).
        """
        v = self._v
        elapsed = t - self._t
        active = len(self._active)
        retired: list[int] = []
        while elapsed > 0 and active > 0:
            rate = self.m / active
            # real time needed for V to reach the next GPS completion
            if heap:
                f_next = heap[0][0]
                dt_next = max(0.0, (f_next - v)) / rate
            else:
                dt_next = float("inf")
            if dt_next > elapsed:
                v += rate * elapsed
                elapsed = 0.0
            else:
                v = max(v, heap[0][0])
                elapsed -= dt_next
                while heap and heap[0][0] <= v + 1e-12:
                    aid = heapq.heappop(heap)[1]
                    retired.append(aid)
                    # a deactivated (thinking) agent was not counted in
                    # ``active``, so sweeping past its F_j changes nothing
                    if aid in self._active:
                        active -= 1
        return v, retired


@dataclasses.dataclass(frozen=True)
class GlobalClockSnapshot:
    """Fleet-level view after reconciling the per-replica clocks to ``time``.

    ``virtual_times[k]`` is V_k(time); the global virtual time is the minimum
    over replicas (the conservative fleet reference: an agent admitted
    anywhere gets F >= min_k V_k, so no replica's backlog can starve it) and
    ``lag`` is the spread max_k V_k - min_k V_k — the price of sharding a
    single fair queue across replicas.  A perfectly balanced router keeps the
    lag near zero; the fleet-wide delay guarantee degrades by at most the lag
    on top of each replica's single-backend bound.
    """

    time: float
    virtual_times: tuple[float, ...]
    global_virtual_time: float
    lag: float
    #: replica indices that were live (not failed) at snapshot time; the
    #: global virtual time and lag are computed over these only.  Empty on
    #: snapshots taken before any replica failed (i.e. all replicas live).
    live: tuple[int, ...] = ()


class GlobalVirtualClock:
    """Reconciles K per-replica GPS clocks into one global virtual time.

    Each replica k runs its own :class:`VirtualClock` over its own service
    capacity M_k (all capacities must be expressed in the same cost-units-
    per-time so the V_k are comparable).  Naive per-replica fair queuing
    breaks *global* fairness exactly when the per-replica clocks drift apart
    (cf. locality-aware fair scheduling): an agent routed to a hot replica
    is charged a later virtual finish than an identical agent routed to a
    cold one.  This class makes the drift observable and bounded:

      * ``register`` buffers arrivals (out-of-submission-order tolerated —
        online submission order need not match arrival-time order);
      * ``reconcile(until)`` replays buffered arrivals in arrival-time order
        into their replica's clock, advances every clock to ``until``, and
        returns a :class:`GlobalClockSnapshot` with the global virtual time
        (min over replicas) and the lag bound (max - min);
      * ``pampering_order`` is the fleet-wide selective-pampering order:
        ascending reconciled virtual finish times across all replicas, which
        equals the single-queue Justitia order whenever the lag is zero.

    The per-replica F_j keep the one-shot property (computed once at
    arrival, never reordered by later arrivals), so reconciliation never
    invalidates a replica's local schedule — it only orders replicas'
    queues against each other.
    """

    def __init__(self, capacities: Sequence[float]):
        caps = [float(m) for m in capacities]
        if not caps:
            raise ValueError("need at least one replica capacity")
        self.capacities = caps
        self.clocks = [VirtualClock(m) for m in caps]
        # (t, submit seq, replica, agent_id, cost, kind) min-heap; kind is
        # "arrive" | "suspend" | "resume", replayed in time order so a
        # suspension's GPS-rate change lands between the right arrivals
        self._pending: list[tuple[float, int, int, int, float, str]] = []
        self._seq = 0
        self._horizon = 0.0            # arrivals <= horizon are replayed
        self.virtual_finish: dict[int, float] = {}
        self.replica_of: dict[int, int] = {}
        self._dead: set[int] = set()

    @property
    def n_replicas(self) -> int:
        return len(self.clocks)

    @property
    def live_indices(self) -> tuple[int, ...]:
        return tuple(
            k for k in range(len(self.clocks)) if k not in self._dead
        )

    def register(
        self, replica: int, agent_id: int, t: float, cost: float
    ) -> None:
        """Buffer one arrival for ``reconcile`` to replay (order-free)."""
        if not 0 <= replica < len(self.clocks):
            raise ValueError(f"replica {replica} out of range")
        if replica in self._dead:
            raise ValueError(f"replica {replica} is dead")
        if t < self._horizon - 1e-9:
            raise ValueError(
                f"arrival at {t} predates reconciled horizon {self._horizon}"
            )
        heapq.heappush(
            self._pending,
            (float(t), self._seq, replica, agent_id, float(cost), "arrive"),
        )
        self._seq += 1

    def note_suspend(self, replica: int, agent_id: int, t: float) -> None:
        """Buffer a think-time suspension (GPS deactivation) for replay.

        Only meaningful when the fleet runs with think-time virtual-time
        accrual DISABLED; silently ignored for dead replicas (their clocks
        are frozen — the agent migrates and re-arrives on a survivor).
        """
        if replica in self._dead:
            return
        heapq.heappush(
            self._pending,
            (max(float(t), self._horizon), self._seq, replica, agent_id,
             0.0, "suspend"),
        )
        self._seq += 1

    def note_resume(self, replica: int, agent_id: int, t: float) -> None:
        """Buffer a think-time resume (GPS reactivation) for replay."""
        if replica in self._dead:
            return
        heapq.heappush(
            self._pending,
            (max(float(t), self._horizon), self._seq, replica, agent_id,
             0.0, "resume"),
        )
        self._seq += 1

    def fail_replica(self, replica: int) -> list[tuple[int, float]]:
        """Mark a replica dead; its clock is frozen at its current V.

        Buffered (un-replayed) arrivals bound for the dead replica are
        dropped from the pending heap and returned as ``[(agent_id, cost)]``
        so the caller can :meth:`migrate` them to survivors.  Agents whose
        arrival was already replayed keep their recorded ``virtual_finish``
        — migration never rewrites accrued virtual time.
        """
        if not 0 <= replica < len(self.clocks):
            raise ValueError(f"replica {replica} out of range")
        self._dead.add(replica)
        orphaned = [
            (aid, cost)
            for (_, _, k, aid, cost, kind) in self._pending
            if k == replica and kind == "arrive"
        ]
        # drop EVERY buffered entry for the dead replica (suspends/resumes
        # included — the frozen clock must never be replayed into again)
        pruned = [entry for entry in self._pending if entry[2] != replica]
        if len(pruned) != len(self._pending):
            self._pending = pruned
            heapq.heapify(self._pending)
        return orphaned

    def migrate(
        self, agent_id: int, new_replica: int, t: float, cost: float
    ) -> Optional[float]:
        """Move an agent to a live replica, carrying accrued virtual time.

        The agent enters ``new_replica``'s GPS reference at real time ``t``
        with remaining cost ``cost`` (it now shares that replica's service
        rate — the re-arrival is buffered like any other and replayed in
        time order by ``reconcile``), but if a global ``virtual_finish``
        was already recorded it is KEPT — the agent's place in the
        fleet-wide pampering order reflects the virtual time it accrued
        before the failure, so a crash cannot demote (or promote) an agent
        relative to its peers.  Returns the carried virtual finish time,
        or ``None`` when the agent's first arrival had not been reconciled
        yet (its F_j materializes at the next ``reconcile``).
        """
        if new_replica in self._dead:
            raise ValueError(f"replica {new_replica} is dead")
        self.register(new_replica, agent_id, t, cost)
        self.replica_of[agent_id] = new_replica
        return self.virtual_finish.get(agent_id)

    def steal(
        self, agent_id: int, frm: int, to: int, t: float, cost: float
    ) -> Optional[float]:
        """Move a queued, never-admitted agent between LIVE replicas.

        Work stealing's clock surgery.  Unlike :meth:`migrate` alone —
        whose source replica is dead and already pruned by
        :meth:`fail_replica` — stealing leaves the source clock running,
        so the agent's presence there must be withdrawn first: an
        un-replayed buffered arrival is simply dropped; an arrival that
        ``reconcile`` already replayed is deactivated from the source's
        GPS reference at the steal time (its F_j heap entry retires
        harmlessly as V sweeps past — the same mechanics as a think-time
        deactivation, except the agent never returns).  The re-arrival on
        ``to`` then goes through :meth:`migrate`, which keeps any
        recorded ``virtual_finish`` — a steal can never demote (or
        promote) an agent in the fleet-wide pampering order.  Returns the
        carried virtual finish, or ``None`` when the agent's arrival had
        not been reconciled yet.
        """
        if frm in self._dead:
            raise ValueError(f"replica {frm} is dead — use fail_replica")
        dropped = False
        pruned = []
        for entry in self._pending:
            if (
                not dropped
                and entry[2] == frm
                and entry[3] == agent_id
                and entry[5] == "arrive"
            ):
                dropped = True
                continue
            pruned.append(entry)
        if dropped:
            self._pending = pruned
            heapq.heapify(self._pending)
        else:
            # already replayed into frm's clock: withdraw its GPS share
            heapq.heappush(
                self._pending,
                (max(float(t), self._horizon), self._seq, frm, agent_id,
                 0.0, "suspend"),
            )
            self._seq += 1
        return self.migrate(agent_id, to, t, cost)

    def forget(self, agent_id: int) -> None:
        """Drop a COMPLETED agent's reconciled bookkeeping.

        Streaming fleets call this (after the agent's arrival has been
        reconciled — i.e. from :meth:`ReplicatedBackend.compact`) so
        ``virtual_finish`` / ``replica_of`` and the per-clock retired
        sets stay bounded by the in-flight population rather than growing
        O(agents).  The agent thereafter no longer appears in
        ``pampering_order``.
        """
        self.virtual_finish.pop(agent_id, None)
        self.replica_of.pop(agent_id, None)
        for clock in self.clocks:
            clock.forget(agent_id)

    def reconcile(self, until: float) -> GlobalClockSnapshot:
        """Replay arrivals up to ``until`` and advance the live clocks.

        Dead replicas' clocks stay frozen at their failure-time V; the
        global virtual time and lag are taken over live replicas only, so a
        crash does not drag the fleet reference backwards (``virtual_times``
        still reports every replica, frozen values included).
        """
        until = float(until)
        while self._pending and self._pending[0][0] <= until:
            t, _, replica, agent_id, cost, kind = heapq.heappop(self._pending)
            if kind == "suspend":
                self.clocks[replica].deactivate(agent_id, t)
                continue
            if kind == "resume":
                self.clocks[replica].reactivate(agent_id, t)
                continue
            f = self.clocks[replica].on_arrival(agent_id, t, cost)
            # never overwrite: a migrated agent's re-arrival joins the new
            # clock's GPS reference but its recorded F_j is carried over
            self.virtual_finish.setdefault(agent_id, f)
            self.replica_of[agent_id] = replica
        live = self.live_indices
        if not live:
            raise RuntimeError("all replicas are dead")
        for k in live:
            self.clocks[k].advance(until)
        self._horizon = max(self._horizon, until)
        v = tuple(
            c.now(until) if k not in self._dead else c.value
            for k, c in enumerate(self.clocks)
        )
        v_live = [v[k] for k in live]
        return GlobalClockSnapshot(
            time=until,
            virtual_times=v,
            global_virtual_time=min(v_live),
            lag=max(v_live) - min(v_live),
            live=live,
        )

    # NB: reading the global time / lag goes through reconcile(t) — it is
    # deliberately the only accessor, because sweeping the clocks to t
    # advances the registration horizon (a "getter" here would mutate)

    def pampering_order(self) -> list[int]:
        """Fleet-wide Justitia order: ascending reconciled virtual finish."""
        return sorted(
            self.virtual_finish,
            key=lambda aid: (self.virtual_finish[aid], aid),
        )

    def delay_bound(
        self, c_max: float, c_agent_max: float, service_rate: float = 1.0
    ) -> float:
        """Fleet-wide Theorem B.1 bound: worst per-replica bound, in this
        clock's TIME units.

        Per replica the theorem gives ``2*c_max + C_max/M_k`` iterations
        with ``M_k`` in KV-token units.  This clock stores capacities as
        ``M_k * service_rate`` (cost-units per time unit), so pass the
        backend's ``service_rate`` (iterations per time unit — e.g. the
        sim's ``decode_rate`` when the clock runs in workload seconds) to
        recover the pool sizes; the default 1.0 covers clocks built
        directly over pool-token capacities in iteration time.  Every
        agent's real finish trails its *own replica's* GPS reference by at
        most this, so the worst replica bounds the whole fleet.
        Heterogeneous fleets with differing per-child service rates need
        per-replica conversion — compute the bound per child instead.

        Dead replicas are excluded: after a failure the bound is re-derived
        over the surviving capacities (it can only grow, since the worst
        live replica may have less capacity headroom than before).
        """
        r = float(service_rate)
        caps = [self.capacities[k] for k in self.live_indices]
        if not caps:
            raise RuntimeError("all replicas are dead")
        return max(
            (2.0 * float(c_max) + float(c_agent_max) * r / cap) / r
            for cap in caps
        )
