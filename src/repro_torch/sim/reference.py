"""Retained pre-rewrite simulator core: the behavioural oracle.

This is the O(events × running) discrete-event loop the event-indexed
``repro_torch.sim.ClusterSim`` replaced: every event re-accounts service for all
running sequences (``account``), re-sums pool occupancy, probes the next
finish/prefill boundary with ``min()`` over the running set, and fully
re-sorts the waiting/swapped queues on every admission pass.  It is kept —
deliberately slow and simple — as the ground truth the optimized core is
pinned to:

* ``tests/test_sim_equivalence.py`` property-checks that both cores produce
  identical completion orders and JCTs across mixed arrival patterns;
* ``benchmarks/perf.py`` asserts identical JCT/finish dicts on a seeded
  1k-agent workload before recording the optimized core's throughput, and
  reports the measured speedup against this implementation.

Semantics are identical to the optimized core by construction (one
admission-pass structure, same event-ordering cascade arrival >
completion > saturation, same vLLM swap policy); the only intentional
change from the historical seed code is shared with the optimized core:
the admission fit check happens *before* a request joins ``running``, so a
pass can no longer push occupancy past M (except for the documented
oversized-request-on-idle-pool escape hatch).

Do not grow features here — this file only changes when the *semantics*
of the simulator change, in lockstep with ``cluster.py``.  Two
post-rewrite lockstep additions exist, both off by default and provably
inert to the dynamics when off:

* ``token_events`` — the discretized token-boundary emission overlay
  (see the cluster.py module doc): a pure emission sweep at the top of
  every event trip, identical float-for-float in both cores.
* ``prefix_cache`` (PR 6) — the analytic prefix-cache model: an
  admission's prefill event is shortened by the modeled hit and only the
  uncached suffix is charged as prefill service, with the identical
  float expressions as the optimized core.  Off, every expression
  reduces to the pre-cache arithmetic bit-for-bit (``hit == 0.0`` and
  ``x - 0.0 == x`` for positive prefills).
* ``admission_watermark`` (PR 8) — the hysteresis admission gate: a NEW
  admission that would lift occupancy above the high watermark is
  deferred while anything is running, until occupancy drains to the low
  watermark.  Off (``None``), the admission pass is untouched — the gate
  branch is never entered.
* ``suspend_retention`` (PR 9) — suspended agents: a stage whose
  ``SimAgent.resume_delays`` entry is positive suspends the agent (no
  decode slot) until its resume time, with its conversation-tail KV
  ``hold``-resident (charged via a held total), ``spill``-parked (a
  ``swap_penalty`` restore trip at resume) or ``drop``-released; memory
  pressure escalates held KV hold→spill BEFORE swapping any running
  sequence.  With no suspensions the held total stays 0.0 and every
  adjusted expression reduces to the prior arithmetic bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import heapq  # noqa: F401  (parity of imports with the historical core)
from typing import Any, Sequence

from repro_torch.core.cost import inference_cost
from repro_torch.core.schedulers import AgentScheduler, Request
from repro_torch.sim.cluster import SimAgent, SimResult


@dataclasses.dataclass
class _Running:
    req: Request
    admit_time: float
    prefill_done: float          # absolute time decoding starts
    d_base: float                # decoded tokens at (re-)admission anchor
    decoded_at_last: float       # decoded tokens at last account time
    last_account: float          # time of last service accounting
    swapped: bool = False
    # finish time, computed ONCE at (re-)admission with the exact same
    # float expression the event-indexed core pushes into its finish
    # calendar — recomputing it per event from the updated accounting
    # anchors shifts the result in the last bits, and a 1e-12 jitter in
    # event times is enough to flip exact-tie VTC counter comparisons
    # between the two cores
    fin: float = float("inf")
    tokens_emitted: int = 0      # token boundaries streamed (token_events)

    def occupancy(self, t: float, decode_rate: float) -> float:
        return self.req.spec.prefill + self.decoded(t, decode_rate)

    def decoded(self, t: float, decode_rate: float) -> float:
        """Stable closed form, anchored at (re-)admission only.

        Accumulating decode progress across per-event accounting anchors
        (the historical formulation) yields bit-different values depending
        on how the interval was partitioned; both cores use this anchored
        form so decode state — and every event time derived from it — is
        identical float-for-float between them.  The snap window mirrors
        the historical accounting's float-Zeno guard.
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


class ReferenceClusterSim:
    """Pre-rewrite ``ClusterSim``: per-event rescans, per-pass re-sorts."""

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
    ):
        self.sched = scheduler
        self.m = float(total_kv)
        self.decode_rate = float(decode_rate)
        self.prefill_rate = float(prefill_rate)
        self.swap_penalty = float(swap_penalty)
        self.listener = listener
        self.token_events = bool(token_events)
        self.prefix_cache = bool(prefix_cache)
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
        if suspend_retention not in ("hold", "spill", "drop"):
            raise ValueError(
                f"suspend_retention must be 'hold', 'spill' or 'drop',"
                f" got {suspend_retention!r}"
            )
        self.suspend_retention = suspend_retention

    def _emit(self, event: str, *args) -> None:
        if self.listener is not None:
            fn = getattr(self.listener, event, None)
            if fn is not None:
                fn(*args)

    # ------------------------------------------------------------------ run

    def run(self, agents: Sequence[SimAgent]) -> SimResult:
        import time as _time

        agents = sorted(agents, key=lambda a: (a.arrival, a.agent_id))
        by_id = {a.agent_id: a for a in agents}
        arrivals = list(agents)
        ai = 0
        waiting: list[Request] = []
        swapped: list[_Running] = []
        running: list[_Running] = []
        rid_counter = 0
        t = 0.0
        result = SimResult(jct={}, finish={})
        seeded_groups: set[str] = set()
        wm_state = {"gated": False}
        wm_emitted: set[int] = set()
        # suspension state (PR 9) — LOCKSTEP with the optimized core
        resume_heap: list[tuple[float, int, int]] = []
        held: dict[int, float] = {}
        spilled: set[int] = set()
        penalized: set[int] = set()
        held_total = 0.0
        rseq = 0
        _sched_clock = 0.0
        _decisions = 0
        _key_evals = 0

        def key(req: Request, now: float):
            nonlocal _key_evals
            _key_evals += 1
            return self.sched.request_key(req, now)

        def submit_stage(agent: SimAgent, now: float) -> None:
            nonlocal rid_counter
            specs = agent.stages[agent.next_stage]
            hints = None
            if (agent.cached_hints is not None
                    and agent.next_stage < len(agent.cached_hints)):
                hints = agent.cached_hints[agent.next_stage]
            agent.next_stage += 1
            agent.live_inferences += len(specs)
            for i, spec in enumerate(specs):
                waiting.append(
                    Request(
                        agent_id=agent.agent_id,
                        rid=rid_counter,
                        spec=spec,
                        submit_time=now,
                        pred_cost=inference_cost(spec, agent.family),
                        cached_prefix=(
                            float(hints[i])
                            if hints is not None and i < len(hints) else 0.0
                        ),
                    )
                )
                rid_counter += 1

        def prefix_hit(req: Request, now: float, deferred: list) -> float:
            """Analytic prefix-cache hit — LOCKSTEP with the optimized
            core's ``_prefix_hit`` (same expressions, same seeded-group
            rule, same accounting); 0.0 with the cache off."""
            if not self.prefix_cache:
                return 0.0
            agent = by_id[req.agent_id]
            base = 0.0
            if agent.prefix_group and agent.prefix_group in seeded_groups:
                base = float(agent.shared_prefix)
            hit = max(base, float(req.cached_prefix))
            if hit > req.spec.prefill:
                hit = float(req.spec.prefill)
            if agent.prefix_group:
                seeded_groups.add(agent.prefix_group)
            aid = req.agent_id
            result.agent_prefill_tokens[aid] = (
                result.agent_prefill_tokens.get(aid, 0.0)
                + req.spec.prefill
            )
            if hit > 0.0:
                result.agent_hit_tokens[aid] = (
                    result.agent_hit_tokens.get(aid, 0.0) + hit
                )
                result.prefill_tokens_saved += hit
                deferred.append(
                    ("on_prefix_hit", aid, req.rid, hit,
                     float(req.spec.prefill), now)
                )
            return hit

        def occupancy(now: float) -> float:
            return sum(r.occupancy(now, self.decode_rate) for r in running)

        def account(now: float) -> None:
            """Credit service between last accounting point and ``now``."""
            for r in running:
                dt_total = now - r.last_account
                if dt_total <= 0:
                    continue
                # decode progress only after prefill completes
                dec_start = max(r.last_account, r.prefill_done)
                dt_dec = max(0.0, now - dec_start)
                new_decoded = r.decoded(now, self.decode_rate)
                d_tokens = new_decoded - r.decoded_at_last
                # KV token-time integral: occupancy dt, converted to
                # token-iterations via decode_rate (1 iteration == 1/rate s)
                occ0 = r.req.spec.prefill + r.decoded_at_last
                kv_tt = (occ0 * dt_total + 0.5 * d_tokens * dt_dec) * self.decode_rate
                self.sched.on_service(
                    r.req.agent_id,
                    kv_token_time=kv_tt,
                    decode_tokens=d_tokens,
                )
                r.decoded_at_last = new_decoded
                r.last_account = now

        def resume(r: _Running, now: float, deferred: list) -> None:
            r.swapped = False
            r.last_account = now
            r.prefill_done = max(r.prefill_done, now + self.swap_penalty)
            r.d_base = r.decoded_at_last
            r.fin = r.finish_time(self.decode_rate)
            running.append(r)
            deferred.append(("on_swap_in", r.req.agent_id, r.req.rid, now))

        def suspend(agent: SimAgent, delay: float, now: float) -> None:
            """Park a closed-loop agent for ``delay`` seconds of think
            time — LOCKSTEP with the optimized core's ``_suspend``."""
            nonlocal held_total, rseq
            aid = agent.agent_id
            stage = agent.next_stage - 1
            until = now + float(delay)
            h = 0.0
            if self.suspend_retention == "hold":
                spec = agent.stages[stage][-1]
                h = float(spec.prefill + spec.decode)
            held[aid] = h
            held_total += h
            if self.suspend_retention == "spill":
                spilled.add(aid)
            rseq += 1
            heapq.heappush(resume_heap, (until, rseq, aid))
            result.suspensions += 1
            if held_total > result.held_peak:
                result.held_peak = held_total
            self.sched.on_agent_suspend(aid, now)
            self._emit("on_suspend", aid, stage, until, now)

        def spill_oldest_held() -> float:
            """Escalate hold→spill on the oldest held agent (freed KV) —
            memory pressure victimizes suspended agents before running
            ones.  LOCKSTEP with ``_spill_oldest_held``."""
            nonlocal held_total
            for aid, h in held.items():
                if h > 0.0:
                    held[aid] = 0.0
                    held_total -= h
                    spilled.add(aid)
                    result.suspend_spills += 1
                    return h
            return 0.0

        def admit(now: float) -> None:
            """Admission pass: swapped queue first, then waiting (vLLM)."""
            nonlocal _sched_clock, _decisions, _key_evals
            # listener emits are deferred past the timed window so the
            # reported scheduler overhead measures policy code only
            deferred: list[tuple] = []
            t0 = _time.perf_counter()
            free = self.m - occupancy(now) - held_total
            # swapped queue has absolute priority and blocks new admissions
            _key_evals += len(swapped)
            swapped.sort(key=lambda r: self.sched.request_key(r.req, now))
            while swapped:
                r = swapped[0]
                need = r.req.spec.prefill + r.decoded_at_last
                if need > free:
                    sp = spill_oldest_held()
                    if sp > 0.0:
                        free += sp
                        continue
                    break
                swapped.pop(0)
                resume(r, now, deferred)
                free -= need
            if not swapped:
                _key_evals += len(waiting)
                waiting.sort(key=lambda r: self.sched.request_key(r, now))
                while waiting:
                    req = waiting[0]
                    # the fit check precedes admission so a pass can never
                    # push occupancy past M — except for a request larger
                    # than the whole pool, which would deadlock the backend;
                    # vLLM admits it alone and lets it thrash, so we admit
                    # it when the pool is otherwise idle
                    fits = req.spec.prefill <= free
                    solo_oversized = (
                        not running and req.spec.prefill >= self.m
                    )
                    if not (fits or solo_oversized):
                        sp = spill_oldest_held()
                        if sp > 0.0:
                            free += sp
                            continue
                        break
                    # watermark admission gate — LOCKSTEP with the
                    # optimized core's ``_admit`` (same expressions, same
                    # hysteresis rule, same idle-pool bypass)
                    if self._wm is not None:
                        low, high = self._wm
                        occ_now = self.m - free
                        if running:
                            if wm_state["gated"] and occ_now <= low:
                                wm_state["gated"] = False
                            if (wm_state["gated"]
                                    or occ_now + req.spec.prefill > high):
                                wm_state["gated"] = True
                                if req.rid not in wm_emitted:
                                    wm_emitted.add(req.rid)
                                    result.admission_deferrals += 1
                                    deferred.append((
                                        "on_admission_deferred",
                                        req.agent_id, req.rid, now,
                                    ))
                                break
                        elif occ_now + req.spec.prefill > high:
                            result.wm_bypass_admits += 1
                        peak = occ_now + req.spec.prefill
                        if peak > result.wm_admit_peak:
                            result.wm_admit_peak = peak
                    waiting.pop(0)
                    hit = prefix_hit(req, now, deferred)
                    pf = now + (req.spec.prefill - hit) / self.prefill_rate
                    self.sched.on_service(
                        req.agent_id, prefill_tokens=req.spec.prefill - hit
                    )
                    deferred.append(("on_admit", req.agent_id, req.rid, now))
                    r_new = _Running(
                        req=req,
                        admit_time=now,
                        prefill_done=pf,
                        d_base=0.0,
                        decoded_at_last=0.0,
                        last_account=now,
                    )
                    r_new.fin = r_new.finish_time(self.decode_rate)
                    running.append(r_new)
                    free -= req.spec.prefill
                    if free < 0:      # only reachable via solo_oversized
                        break
            elif not running:
                # swapped head cannot fit but nothing is running: re-admit it
                # anyway (its KV footprint is what it is — vLLM would page)
                resume(swapped.pop(0), now, deferred)
            _decisions += 1
            _sched_clock += _time.perf_counter() - t0
            result.peak_occupancy = max(
                result.peak_occupancy, occupancy(now) + held_total
            )
            for ev in deferred:
                self._emit(*ev)

        def sweep_tokens(now: float) -> None:
            """Token-boundary emission overlay — LOCKSTEP with the
            optimized core's ``_sweep_tokens`` (same float expressions,
            same running-list iteration order, same sort key); see the
            cluster.py module doc.
            """
            rate = self.decode_rate
            batch = []
            for idx, r in enumerate(running):
                d = r.decoded(now, rate)
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
                    if tk > now:
                        tk = now
                    batch.append((tk, idx, k, aid, rid))
                r.tokens_emitted = n
            batch.sort(key=lambda e: e[:3])
            for tk, _, k, aid, rid in batch:
                self._emit("on_token", aid, rid, k - 1, tk)

        def saturation_time(now: float) -> float:
            """When does pool occupancy hit M at current decode rates?

            Only sequences whose prefill has completed are growing; a
            prefill completion is itself an event (see the main loop), after
            which this is recomputed with the new rate.
            """
            occ = occupancy(now)
            free = self.m - occ
            growing = sum(
                1
                for r in running
                if r.prefill_done <= now + 1e-12
                and r.decoded(now, self.decode_rate) < r.req.spec.decode
            )
            if growing == 0:
                return float("inf")
            rate = growing * self.decode_rate
            return now + max(0.0, free - held_total) / rate

        # main event loop
        while (ai < len(arrivals) or waiting or running or swapped
               or resume_heap):
            t_arr = arrivals[ai].arrival if ai < len(arrivals) else float("inf")
            t_res = resume_heap[0][0] if resume_heap else float("inf")
            t_fin = min(
                (r.fin for r in running),
                default=float("inf"),
            )
            t_pref = min(
                (r.prefill_done for r in running if r.prefill_done > t + 1e-12),
                default=float("inf"),
            )
            t_sat = saturation_time(t) if running else float("inf")
            t_next = min(t_arr, t_res, t_fin, t_sat, t_pref)
            if t_next == float("inf"):
                # nothing running/finishing: only waiting items blocked by
                # swapped priority or memory — should not happen if pool can
                # fit smallest request; guard against deadlock
                if waiting or swapped:
                    raise RuntimeError(
                        "simulator deadlock: pool cannot fit pending work"
                    )
                break
            t_next = max(t_next, t)
            account(t_next)
            t = t_next
            result.events += 1
            if self.token_events:
                sweep_tokens(t)

            if t_arr <= t + 1e-12 and ai < len(arrivals):
                agent = arrivals[ai]
                ai += 1
                _t0 = _time.perf_counter()
                self.sched.on_agent_arrival(
                    agent.agent_id, agent.arrival, agent.predicted_cost
                )
                _sched_clock += _time.perf_counter() - _t0
                _decisions += 1
                self._emit("on_arrival", agent.agent_id, t)
                submit_stage(agent, t)
                admit(t)
                continue

            # resumes: think time ended (one per trip, like arrivals)
            if t_res <= t + 1e-12:
                _, _, aid = heapq.heappop(resume_heap)
                if aid in spilled and aid not in penalized:
                    # spilled KV pays the swap-in restore surcharge before
                    # the next stage submits — one deterministic penalty
                    # trip (LOCKSTEP with the optimized core)
                    penalized.add(aid)
                    rseq += 1
                    heapq.heappush(
                        resume_heap, (t + self.swap_penalty, rseq, aid)
                    )
                    continue
                h = held.pop(aid, 0.0)
                held_total -= h
                spilled.discard(aid)
                penalized.discard(aid)
                result.resumes += 1
                agent = by_id[aid]
                _t0 = _time.perf_counter()
                self.sched.on_agent_resume(aid, t)
                _sched_clock += _time.perf_counter() - _t0
                self._emit("on_resume", aid, t)
                submit_stage(agent, t)
                admit(t)
                continue

            # completions
            done = [
                r
                for r in running
                if r.decoded_at_last >= r.req.spec.decode - 1e-9
                and t >= r.prefill_done - 1e-9
            ]
            if done:
                for r in done:
                    running.remove(r)
                    agent = by_id[r.req.agent_id]
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
                                suspend(agent, delay, t)
                            else:
                                submit_stage(agent, t)
                        else:
                            agent.finish = t
                            result.finish[agent.agent_id] = t
                            result.jct[agent.agent_id] = t - agent.arrival
                            _t0 = _time.perf_counter()
                            self.sched.on_agent_complete(agent.agent_id, t)
                            _sched_clock += _time.perf_counter() - _t0
                            self._emit(
                                "on_agent_complete", agent.agent_id, t
                            )
                admit(t)
                continue

            # saturation: swap out the worst-priority running inference —
            # but memory pressure victimizes suspended agents first
            occ_sat = occupancy(t) + held_total if running else 0.0
            if occ_sat >= self.m - 1e-6 and running:
                if held_total > 0.0:
                    spill_oldest_held()
                    continue
                if len(running) > 1:
                    _key_evals += len(running)
                    victim = max(
                        running,
                        key=lambda r: self.sched.request_key(r.req, t),
                    )
                    running.remove(victim)
                    victim.swapped = True
                    swapped.append(victim)
                    result.swaps += 1
                    self._emit(
                        "on_swap_out", victim.req.agent_id, victim.req.rid, t
                    )
                    continue
                # single sequence saturating the pool: let it finish —
                # but never past the next arrival or resume, which must be
                # processed on time (assume p + d < M for all workloads;
                # see App. B assumption)
                r = running[0]
                fin = r.fin
                if ai < len(arrivals):
                    fin = min(fin, arrivals[ai].arrival)
                if resume_heap:
                    fin = min(fin, resume_heap[0][0])
                account(fin)
                t = fin
                continue

        result.sched_decisions = _decisions
        result.sched_time = _sched_clock
        result.key_evals = _key_evals
        result.makespan = t
        return result
