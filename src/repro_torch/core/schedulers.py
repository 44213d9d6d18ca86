"""Agent-level schedulers: Justitia (the paper) and the five baselines.

The same scheduler objects drive both the discrete-event cluster simulator
(`repro.sim`) and the real continuous-batching engine (`repro.engine`) — the
policy code is identical, only the backend differs.

Contract
--------
The backend notifies the scheduler of agent arrivals/completions and of
service as it is dealt, and asks for a *priority key* per pending request
whenever it makes an admission (or swap-victim) decision.  Lower key = served
first.  Keys may be dynamic (VTC, SRJF) and are therefore recomputed at every
scheduling decision; Justitia's key is static by construction (the one-shot
virtual finish time).

Non-preemption (paper §4.3 + App. C) is enforced by the *backend*: a waiting
request never preempts a running inference; swapping happens only on memory
pressure, evicting the running request with the *worst* key.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

from repro_torch.core.cost import InferenceSpec
from repro_torch.core.registry import (
    register_scheduler,
    resolve_scheduler,
    scheduler_names,
)
from repro_torch.core.virtual_time import VirtualClock


@dataclasses.dataclass
class Request:
    """One inference task as seen by the scheduler/backend."""

    agent_id: int
    rid: int                      # globally unique, monotone with submit order
    spec: InferenceSpec
    submit_time: float
    pred_cost: float = 0.0        # predicted inference-level KV token-time
    #: expected cached-prefix length (tokens) for this request's prompt —
    #: a STATIC workload hint (shared system prefix / conversation
    #: history), not a live cache probe: scheduler keys must stay stable
    #: between ``version`` bumps, so they must not query the allocator
    cached_prefix: float = 0.0

    # runtime state owned by the backend
    decoded: int = 0              # decode tokens produced so far


@dataclasses.dataclass
class AgentRecord:
    agent_id: int
    arrival: float
    predicted_cost: float         # predicted agent-level cost (model units)
    virtual_finish: float = float("inf")   # Justitia F_j
    serviced_kv: float = 0.0      # accumulated KV token-time service
    serviced_vtc: float = 0.0     # accumulated VTC-weighted token service
    completed: bool = False


class AgentScheduler:
    """Base class; default key is inference-level FCFS."""

    name = "base"
    #: whether this scheduler's admission key depends on runtime state
    dynamic = False
    #: dynamic policies only: True iff ``request_key`` reads nothing beyond
    #: the request and its own agent's record — then a queued request's key
    #: can only move when that agent is serviced, and backends may keep
    #: queues sorted and reposition just the serviced agents' requests
    #: (``repro.core.OrderedQueue`` grouped mode) instead of re-sorting
    agent_keyed = False

    def __init__(self) -> None:
        self.agents: dict[int, AgentRecord] = {}
        #: mutation counter: bumped whenever scheduler state that keys may
        #: read changes (arrivals, completions, service deals).  Backends
        #: pass it to ``repro.core.OrderedQueue.refresh`` so dynamic-policy
        #: queues re-sort only when keys can actually have moved.  Keys must
        #: not depend on the clock ``t`` directly (see queueing module doc).
        self.version = 0

    # -- lifecycle ----------------------------------------------------------

    def on_agent_arrival(self, agent_id: int, t: float, predicted_cost: float) -> None:
        self.agents[agent_id] = AgentRecord(agent_id, t, float(predicted_cost))
        self.version += 1

    def on_agent_complete(self, agent_id: int, t: float) -> None:
        rec = self.agents.get(agent_id)
        if rec is not None:
            rec.completed = True
        self.version += 1

    def on_agent_cancel(self, agent_id: int, t: float) -> None:
        """The agent was withdrawn before any of its requests ran (fleet
        work stealing, PR 10).  Default: the completion cleanup — the
        record is marked done so dynamic policies stop considering it.
        Policies that registered the agent in auxiliary state at arrival
        (Justitia's GPS clock) override to undo that registration too."""
        self.on_agent_complete(agent_id, t)

    def on_agent_suspend(self, agent_id: int, t: float) -> None:
        """The agent entered think time (PR 9): it holds no decode slot
        until the matching :meth:`on_agent_resume`.  Default: no-op —
        the stock policies key on arrival-anchored or service-accrued
        state, neither of which a suspension moves."""

    def on_agent_resume(self, agent_id: int, t: float) -> None:
        """Think time ended; the agent's next stage was submitted."""

    def on_service(
        self,
        agent_id: int,
        *,
        kv_token_time: float = 0.0,
        prefill_tokens: float = 0.0,
        decode_tokens: float = 0.0,
        w_p: float = 1.0,
        w_d: float = 2.0,
    ) -> None:
        rec = self.agents.get(agent_id)
        if rec is None:
            return
        rec.serviced_kv += kv_token_time
        rec.serviced_vtc += w_p * prefill_tokens + w_d * decode_tokens
        self.version += 1

    # -- the decision -------------------------------------------------------

    def request_key(self, req: Request, t: float) -> tuple:
        return (req.submit_time, req.rid)

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, total_kv: float, service_rate: float = 1.0) -> "AgentScheduler":
        """Uniform constructor used by the registry-backed factory; policies
        that need backend capacity parameters (Justitia) override this."""
        return cls()


@register_scheduler("vllm-fcfs", "vllm", "fcfs")
class VllmFcfsScheduler(AgentScheduler):
    """Baseline (a): vLLM — inference-level First-Come-First-Serve."""

    name = "vllm-fcfs"


@register_scheduler("vllm-sjf", "sjf")
class VllmSjfScheduler(AgentScheduler):
    """Baseline (b): vLLM-SJF — inference-level Shortest-Job-First using the
    per-inference predicted cost (the paper uses DistilBERT-predicted
    durations; we feed it the same predictor output as everyone else)."""

    name = "vllm-sjf"

    def request_key(self, req: Request, t: float) -> tuple:
        return (req.pred_cost, req.submit_time, req.rid)


@register_scheduler("parrot", "agent-fcfs")
class ParrotScheduler(AgentScheduler):
    """Baseline (c): Parrot — agent-level FCFS (all inferences of the
    earliest-arrived agent served consecutively)."""

    name = "parrot"

    def request_key(self, req: Request, t: float) -> tuple:
        rec = self.agents[req.agent_id]
        return (rec.arrival, rec.agent_id, req.rid)


@register_scheduler("vtc")
class VtcScheduler(AgentScheduler):
    """Baseline (d): Virtual Token Counter (Sheng et al., OSDI'24).

    Tracks the weighted token service each agent has received and always
    admits from the agent with the smallest counter — approximating
    instantaneous fair sharing.  On arrival of an agent during a backlogged
    period its counter is lifted to the minimum over active agents
    (the paper's 'counter lift' that prevents gaming by idling).

    The lift is O(log n) amortized via a lazy min-heap of *lower bounds*
    (the original VTC paper ships an O(log n) counter for exactly this
    reason): each live agent keeps one ``(counter, agent_id)`` entry,
    pushed at arrival.  Counters only grow, so an entry is always a lower
    bound on its agent's current counter; when the heap top is stale it is
    ``heapreplace``-refreshed in place, and when the top matches its
    agent's live counter that value IS the minimum.  Service deals never
    touch the heap — the refresh work collapses into the next lift.  A
    linear scan per arrival made the lift O(n²) across a backlogged
    workload.
    """

    name = "vtc"
    dynamic = True
    agent_keyed = True

    def __init__(self) -> None:
        super().__init__()
        self._min_heap: list[tuple[float, int]] = []  # (lower bound, aid)

    def _min_live(self) -> Optional[float]:
        """Smallest ``serviced_vtc`` over live agents (lazy lower bounds)."""
        heap = self._min_heap
        agents = self.agents
        while heap:
            v, aid = heap[0]
            rec = agents.get(aid)
            if rec is None or rec.completed:
                heapq.heappop(heap)
                continue
            current = rec.serviced_vtc
            if current == v:
                # v is a true live counter and every other entry is a
                # lower bound of its own (>= v) counter: v is the min
                return v
            heapq.heapreplace(heap, (current, aid))
        return None

    def on_agent_arrival(self, agent_id: int, t: float, predicted_cost: float) -> None:
        super().on_agent_arrival(agent_id, t, predicted_cost)
        lifted = self._min_live()
        rec = self.agents[agent_id]
        if lifted is not None:
            rec.serviced_vtc = lifted
        heapq.heappush(self._min_heap, (rec.serviced_vtc, agent_id))

    def request_key(self, req: Request, t: float) -> tuple:
        rec = self.agents[req.agent_id]
        return (rec.serviced_vtc, rec.arrival, req.rid)


@register_scheduler("srjf")
class SrjfScheduler(AgentScheduler):
    """Baseline (e): Shortest-Remaining-Job-First at the *agent* level, on
    the same predicted KV token-time costs Justitia uses."""

    name = "srjf"
    dynamic = True
    agent_keyed = True

    def request_key(self, req: Request, t: float) -> tuple:
        rec = self.agents[req.agent_id]
        remaining = max(0.0, rec.predicted_cost - rec.serviced_kv)
        return (remaining, rec.arrival, req.rid)


@register_scheduler("justitia")
class JustitiaScheduler(AgentScheduler):
    """The paper: virtual-time fair queuing with selective pampering.

    On agent arrival we compute, one-shot, its GPS virtual finish time
    F_j = V(a_j) + C_j (predicted) and use ascending F_j as a *static*
    agent priority; all inferences of the pampered agent run consecutively
    and saturate the backend.  Theorem B.1 bounds the worst-case delay vs
    GPS by 2*c_max + C_max/M.
    """

    name = "justitia"

    def __init__(self, total_kv: float, service_rate: float = 1.0):
        """``total_kv``: pool size M in KV-token units (the paper's M).

        ``service_rate``: how many decode iterations the backend completes
        per unit of real time (tokens/s per running sequence).  The GPS
        virtual clock must advance at the backend's *service capacity*
        M * service_rate in KV-token-time per second — the cost model's
        units are token·iterations while wall time is seconds (Eq. 2 is
        stated with time measured in iterations; this converts it).
        """
        super().__init__()
        self.clock = VirtualClock(total_kv * service_rate)

    def on_agent_arrival(self, agent_id: int, t: float, predicted_cost: float) -> None:
        super().on_agent_arrival(agent_id, t, predicted_cost)
        f = self.clock.on_arrival(agent_id, t, predicted_cost)
        self.agents[agent_id].virtual_finish = f

    def on_agent_complete(self, agent_id: int, t: float) -> None:
        super().on_agent_complete(agent_id, t)
        self.clock.advance(t)

    def on_agent_cancel(self, agent_id: int, t: float) -> None:
        # a stolen agent leaves WITHOUT service: pull it out of the GPS
        # reference so it stops depressing V's rate for the agents that
        # stay (its F_j heap entry retires harmlessly as V sweeps past)
        super().on_agent_cancel(agent_id, t)
        self.clock.deactivate(agent_id, t)

    def request_key(self, req: Request, t: float) -> tuple:
        rec = self.agents[req.agent_id]
        return (rec.virtual_finish, rec.arrival, req.rid)

    @classmethod
    def build(cls, total_kv: float, service_rate: float = 1.0) -> "JustitiaScheduler":
        return cls(total_kv, service_rate)


@register_scheduler("locality_fair")
class LocalityFairScheduler(VtcScheduler):
    """Deficit-bounded longest-prefix-match scheduling (PR 6).

    *Locality-aware Fair Scheduling in LLM Serving* (PAPERS.md) shows the
    two pure extremes both fail on conversational workloads: strict fair
    queuing (VTC/Justitia order) interleaves agents and destroys prefix-
    cache locality, while pure longest-prefix-match starves cold agents.
    This policy serves the best cache-locality candidate — highest
    expected cached-prefix fraction, from the static workload hint on
    each request — *unless* the candidate agent's fairness deficit
    exceeds ``deficit_bound``, at which point it falls behind every
    in-bound agent and the order degrades to Justitia's virtual-finish
    fair queue.

    The deficit is measured in VTC service units: ``serviced_vtc`` minus
    the minimum over live agents (VTC's lazy O(log n) min-heap, reused).
    An over-served agent keeps its locality bonus only while within
    ``deficit_bound`` of the most-starved agent, so the max extra delay
    any agent can suffer to locality is the time to deal
    ``deficit_bound`` service units — the bounded-pampering knob the
    BENCH cells sweep.  The default bound is ONE pool capacity of
    service: a multi-turn session accumulates service of the same order
    as the pool itself, so a materially tighter bound (e.g. half a
    pool) trips mid-session under contention and collapses the order to
    plain fair queuing — BENCH_cache's deficit sweep shows the hit rate
    degrading from the pure-LPM ceiling toward VTC's as the bound
    shrinks below one pool.

    ``dynamic=True`` and ``agent_keyed=False`` per the OrderedQueue
    contract: the key reads the GLOBAL min counter, so one agent's
    service deal can move every queued request's key — backends re-sort
    lazily when ``version`` moves, not per-agent.
    """

    name = "locality_fair"
    dynamic = True
    agent_keyed = False

    def __init__(self, total_kv: float, service_rate: float = 1.0,
                 deficit_bound: Optional[float] = None):
        super().__init__()
        self.clock = VirtualClock(total_kv * service_rate)
        #: max VTC-service lead an agent may hold and still keep its
        #: locality bonus; defaults to one pool's KV-token capacity of
        #: service (see the class docstring for why tighter bounds
        #: collapse to fair queuing on multi-turn sessions)
        self.deficit_bound = (
            float(total_kv) if deficit_bound is None
            else float(deficit_bound)
        )

    def on_agent_arrival(self, agent_id: int, t: float,
                         predicted_cost: float) -> None:
        super().on_agent_arrival(agent_id, t, predicted_cost)  # VTC lift
        f = self.clock.on_arrival(agent_id, t, predicted_cost)
        self.agents[agent_id].virtual_finish = f

    def on_agent_complete(self, agent_id: int, t: float) -> None:
        super().on_agent_complete(agent_id, t)
        self.clock.advance(t)

    def request_key(self, req: Request, t: float) -> tuple:
        rec = self.agents[req.agent_id]
        m = self._min_live()
        deficit = rec.serviced_vtc - (m if m is not None else 0.0)
        over = 1 if deficit > self.deficit_bound else 0
        frac = min(
            1.0, req.cached_prefix / max(1.0, float(req.spec.prefill))
        )
        return (over, -frac, rec.virtual_finish, rec.arrival, req.rid)

    @classmethod
    def build(cls, total_kv: float,
              service_rate: float = 1.0) -> "LocalityFairScheduler":
        return cls(total_kv, service_rate)


def make_scheduler(
    name: str, total_kv: float, service_rate: float = 1.0
) -> AgentScheduler:
    """Factory used by the simulator, the engine, and the benchmarks.

    Resolves ``name`` through the plugin registry
    (``repro.core.registry``); any policy decorated with
    ``@register_scheduler`` — including ones defined outside this module —
    is constructible here.  ``service_rate`` (decode iterations per second)
    only matters for Justitia's virtual clock; see
    ``JustitiaScheduler.__init__``.
    """
    return resolve_scheduler(name).build(total_kv, service_rate)


def __getattr__(attr: str):
    # ALL_SCHEDULERS is derived from the registry at access time so that
    # policies registered after this module imported still show up.
    if attr == "ALL_SCHEDULERS":
        return scheduler_names()
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")
