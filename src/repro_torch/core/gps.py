"""GPS (Generalized Processor Sharing) fluid reference scheduler.

The idealized fair scheduler the paper uses as the fairness yardstick: the
backend's M KV-token units of service rate are arbitrarily divisible and
split equally among the N_t active agents at every instant.  Agent j,
arriving at a_j with total cost C_j (KV token-time), accumulates service at
rate M/N_t and completes at the real time f̄_j where its accumulated service
reaches C_j.

Used by the property tests to check Theorem B.1
(f_j − f̄_j ≤ 2 c_max + C_max / M) against the packetized simulator, and by
the benchmarks to report finish-time fairness against the ideal.

``gps_finish_times`` applies the standard *virtual-work transform* (WFQ —
Demers et al. 1989; Parekh & Gallager 1993): define V(t) with
dV/dt = M/N_t, i.e. V is the cumulative fair-share work an agent active
since time 0 would have received.  Every active agent accrues service at
exactly dV per dt, so agent j finishes when V crosses the *threshold*
F_j = V(a_j) + C_j — a min-heap of thresholds replaces the per-event
remaining-cost sweep, turning the O(n · active) fluid loop into
O(n log n).  The pre-transform loop is retained as
``gps_finish_times_fluid`` and the two are pinned to each other by an
equivalence property test.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class GpsAgent:
    agent_id: int
    arrival: float
    cost: float  # total KV token-time


def gps_finish_times(agents: Sequence[GpsAgent], total_kv: float) -> dict[int, float]:
    """Virtual-work GPS sweep; O(n log n), exact up to float error.

    Equivalent to :func:`gps_finish_times_fluid` (the event-driven fluid
    integration) but finishes agents by popping virtual thresholds off a
    min-heap instead of rescanning every active agent's remaining cost at
    each event.
    """
    if total_kv <= 0:
        raise ValueError("total_kv must be positive")
    m = float(total_kv)
    order = sorted(agents, key=lambda a: (a.arrival, a.agent_id))
    n = len(order)
    finish: dict[int, float] = {}
    heap: list[tuple[float, int]] = []   # (F_j threshold, agent_id)
    t = 0.0
    v = 0.0                              # virtual work W(t)
    i = 0
    while i < n or heap:
        if not heap:
            # idle: V stalls (only backlogged periods need ordering), the
            # clock jumps to the next arrival batch
            t = max(t, order[i].arrival)
            while i < n and order[i].arrival <= t + 1e-12:
                heapq.heappush(heap, (v + order[i].cost, order[i].agent_id))
                i += 1
            continue
        rate = m / len(heap)             # dV/dt while N_t agents are active
        t_arr = order[i].arrival if i < n else float("inf")
        t_drain = t + max(0.0, heap[0][0] - v) / rate
        if t_drain <= t_arr + 1e-12:
            # V crosses the smallest threshold: that agent (and any other
            # within the fluid loop's drain tolerance) finishes at t_drain
            v = max(v, heap[0][0])
            t = t_drain
            while heap and heap[0][0] <= v + 1e-6:
                _, aid = heapq.heappop(heap)
                finish[aid] = t
        else:
            v += rate * (t_arr - t)
            t = t_arr
            while i < n and order[i].arrival <= t + 1e-12:
                heapq.heappush(heap, (v + order[i].cost, order[i].agent_id))
                i += 1
    return finish


def gps_finish_times_fluid(
    agents: Sequence[GpsAgent], total_kv: float
) -> dict[int, float]:
    """Event-driven fluid simulation; the pre-transform reference.

    O((n log n) + n * active) — retained as the oracle for the virtual-work
    implementation above (see tests/test_sim_equivalence.py); prefer
    :func:`gps_finish_times` everywhere else.
    """
    if total_kv <= 0:
        raise ValueError("total_kv must be positive")
    m = float(total_kv)
    pending = sorted(agents, key=lambda a: (a.arrival, a.agent_id))
    finish: dict[int, float] = {}
    active: dict[int, float] = {}  # agent_id -> remaining cost
    t = 0.0
    i = 0
    n = len(pending)
    while i < n or active:
        if not active:
            # jump to next arrival
            t = max(t, pending[i].arrival)
            while i < n and pending[i].arrival <= t:
                active[pending[i].agent_id] = pending[i].cost
                i += 1
            continue
        rate = m / len(active)
        # time until the first active agent would drain at current rate
        min_rem = min(active.values())
        t_drain = t + min_rem / rate
        t_next_arrival = pending[i].arrival if i < n else float("inf")
        t_event = min(t_drain, t_next_arrival)
        dt = t_event - t
        for k in list(active):
            active[k] -= rate * dt
        t = t_event
        done = [k for k, rem in active.items() if rem <= 1e-6]
        if not done and t_event == t_drain and dt <= 0.0:
            # float underflow: min_rem/rate rounds to zero at this time
            # magnitude — the min-remaining agent is done for all purposes
            done = [min(active, key=active.get)]
        for k in done:
            finish[k] = t
            del active[k]
        while i < n and pending[i].arrival <= t + 1e-12:
            active[pending[i].agent_id] = pending[i].cost
            i += 1
    return finish
