"""The ``Backend`` protocol and its two implementations.

A backend is anything that can accept :class:`AgentSpec` submissions with
arrival times, advance a clock, and drain to completion — the
:class:`repro.api.AgentService` facade drives simulator and engine through
this one surface, so a workload script switches backend with one flag.

Contract (all times in *workload seconds*):

  * ``submit(spec, agent_id)`` registers an agent arriving at
    ``max(spec.arrival, now)``; submissions may happen at any point, also
    interleaved with ``run`` — both backends support online arrivals.
  * ``run(until)`` advances the backend clock to ``until`` (the simulator
    is event-driven and advances lazily at drain; the engine really steps).
  * ``drain(max_time)`` runs everything submitted so far to completion and
    returns a :class:`BackendResult`.
  * ``set_listener(listener)`` installs the duck-typed lifecycle callback
    receiver (``on_arrival``/``on_admit``/``on_swap_out``/``on_swap_in``/
    ``on_token``/``on_stage_complete``/``on_agent_complete``) in backend-
    native time; ``to_workload_time`` converts those stamps back to seconds.

To add a backend: implement this protocol over your runtime, map workload
seconds onto its native clock, and forward its scheduler interactions to a
``repro.core.SchedulerPolicy`` — see ROADMAP.md "Serving API".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core import make_scheduler
from repro_torch.core.cost import InferenceSpec, MemoryFamily, agent_cost
from repro_torch.core.schedulers import AgentScheduler
from repro_torch.engine import EngineAgent, ServeEngine
from repro_torch.sim import ClusterSim, SimAgent


@dataclasses.dataclass
class AgentSpec:
    """Backend-agnostic description of one task-parallel agent.

    ``stages`` uses the cost model's :class:`InferenceSpec` (full-scale
    token counts, as the paper's workload suite samples them); backends map
    them onto their own granularity (the engine divides by its
    ``token_scale``).  ``prompts`` optionally pins exact engine prompt
    token arrays per stage, used verbatim (already engine-scale); decode
    budgets still come from ``stages`` and are scaled.  When ``prompts``
    is absent the engine synthesizes prompts of the scaled lengths.

    ``next_stage`` makes the agent CLOSED-LOOP: after every stage
    completes, :class:`repro.api.AgentService` feeds the callback a
    :class:`repro.api.events.StageOutcome` (prior stage's events: index,
    completion time, tokens observed) and, if it returns a non-empty
    ``InferenceSpec`` list, submits that list as the agent's next stage
    mid-run through ``Backend.submit_stage`` — the agent only completes
    once the callback declines.  ``stages`` then holds just the opening
    turn(s); ``predicted_cost``/``true_cost`` should be supplied
    explicitly (``resolved_costs`` can only see the static prefix).  The
    callback runs inside the backend's event loop and must not call
    ``run``/``drain`` (see ROADMAP "closed-loop clients").

    Prefix-cache metadata (all optional — see ROADMAP "Prefix cache"):

      * ``prompt_ids`` pins CANONICAL full-scale prompt token ids per
        stage/inference.  Unlike ``prompts`` (engine-scale, verbatim),
        these are workload-scale streams the engine down-converts with
        ``ids[:ceil_scaled_len] % vocab`` — a conversion that preserves
        prefix-extension, so two prompts sharing a canonical prefix
        share an engine-token prefix too.  ``prompts`` wins when both
        are set.
      * ``prefix_group`` names the shared-system-prompt family (e.g. the
        closed-loop class) and ``shared_prefix`` the family's shared
        prefix length in full-scale tokens — the simulator's analytic
        cache model grants cross-agent hits of ``shared_prefix`` once
        any group member has been admitted.
      * ``cached_hints`` gives the a-priori expected cached-prefix
        length (full-scale tokens) per stage/inference.  Backends pass
        it to the scheduler as the STATIC ``Request.cached_prefix``
        hint (locality-aware policies sort on it) and the simulator's
        analytic model uses it for within-session hits.  It never
        touches the engine's real allocator, which matches by content.
    """

    stages: list[list[InferenceSpec]]
    arrival: float = 0.0
    predicted_cost: Optional[float] = None   # default: true memory-centric cost
    true_cost: Optional[float] = None
    family: MemoryFamily = MemoryFamily.DENSE
    name: str = "agent"
    prompts: Optional[list[list[np.ndarray]]] = None
    #: closed-loop stage generator: StageOutcome -> next stage's specs|None
    next_stage: Optional[Any] = None
    prompt_ids: Optional[list[list[np.ndarray]]] = None
    prefix_group: str = ""
    shared_prefix: float = 0.0
    cached_hints: Optional[list[list[float]]] = None

    def flat_specs(self) -> list[InferenceSpec]:
        return [s for stage in self.stages for s in stage]

    def resolved_costs(self) -> tuple[float, float]:
        """(predicted, true) cost with defaults filled from the cost model."""
        true = self.true_cost
        if true is None:
            true = agent_cost(self.flat_specs(), self.family)
        pred = self.predicted_cost
        if pred is None:
            pred = true
        return float(pred), float(true)


@dataclasses.dataclass
class BackendResult:
    """What a drained backend hands back, in workload seconds."""

    finish: dict[int, float]              # agent_id -> absolute completion
    jct: dict[int, float]                 # agent_id -> completion - arrival
    makespan: float
    swaps: int = 0
    sched_decisions: int = 0
    sched_time: float = 0.0               # wall-clock spent in scheduler code
    metrics: dict = dataclasses.field(default_factory=dict)


@runtime_checkable
class Backend(Protocol):
    name: str

    @property
    def now(self) -> float: ...

    @property
    def virtual_capacity(self) -> float:
        """GPS service capacity in workload cost-units per workload second.

        This is the rate at which the backend's virtual clock advances when
        one agent is active — what a ``ReplicatedBackend`` feeds to the
        :class:`repro.core.GlobalVirtualClock` so per-replica virtual times
        are comparable across heterogeneous children.
        """
        ...

    def set_listener(self, listener: Any) -> None: ...

    def to_workload_time(self, t: float) -> float: ...

    def submit(self, spec: AgentSpec, agent_id: int) -> float: ...

    def submit_stage(
        self,
        agent_id: int,
        specs: Sequence[InferenceSpec],
        *,
        prompt_ids: Optional[Sequence[np.ndarray]] = None,
        hints: Optional[Sequence[float]] = None,
        resume_delay: Optional[float] = None,
    ) -> None:
        """Append one follow-up stage to a live agent (closed-loop).

        Legal until the agent completes — including from inside an
        ``on_stage_complete`` listener callback, which every backend
        emits BEFORE deciding whether the agent is done, so an appended
        stage seamlessly continues the agent.

        ``prompt_ids``/``hints`` carry the stage's canonical prompt
        token streams and expected cached-prefix lengths (same
        semantics as the :class:`AgentSpec` fields); both optional.

        ``resume_delay`` (workload seconds, PR 9) suspends the agent
        for that long BEFORE this stage starts — tool-call / user think
        time: the agent holds no decode slot, its KV falls under the
        backend's ``suspend_retention`` policy, and the backend emits
        ``on_suspend``/``on_resume`` around the gap.  ``None``/``0``
        submits immediately (bit-identical to pre-PR-9 behaviour).
        """
        ...

    def cancel(self, agent_id: int) -> bool:
        """Withdraw a never-admitted agent (fleet work stealing, PR 10).

        Returns True and silently removes the agent — no events, no
        result entry — when its whole opening stage is still queued (or
        its arrival is still pending); returns False, leaving the
        backend untouched, for any agent that was ever admitted,
        suspended, or has completed.  The fleet uses this to migrate
        queued backlog off an overloaded replica.
        """
        ...

    def run(self, until: float) -> None: ...

    def drain(self) -> BackendResult: ...


def _resolve_scheduler(
    scheduler: "str | AgentScheduler", total_kv: float, service_rate: float
) -> AgentScheduler:
    if isinstance(scheduler, str):
        return make_scheduler(scheduler, total_kv, service_rate)
    return scheduler


class SimBackend:
    """Discrete-event cluster simulator behind the ``Backend`` protocol.

    The event-indexed simulator is incremental: ``submit`` registers the
    agent with the sim immediately (online arrival) and ``run(until)``
    really advances the event loop, so completions are *observed* mid-run —
    lifecycle listeners fire as the clock sweeps them, and load-aware fleet
    routers (``least_loaded``) see the sim's in-flight count drop without
    waiting for ``drain``.  Results are cumulative across submit/drain
    rounds, matching the engine backend's ``completions`` dict.

    ``token_events=True`` turns on the sim's discretized token streaming
    (``TokenGenerated`` at the closed-form boundary instants — see the
    ``repro.sim.cluster`` module doc); off by default because the emission
    sweep costs O(running) per event.
    """

    name = "sim"

    def __init__(
        self,
        scheduler: "str | AgentScheduler" = "justitia",
        *,
        total_kv: float = 16384.0,
        decode_rate: float = 30.0,
        prefill_rate: float = 4000.0,
        swap_penalty: float = 0.2,
        token_events: bool = False,
        prefix_cache: bool = False,
        admission_watermark: Optional[tuple] = None,
        suspend_retention: str = "hold",
        retain_results: bool = True,
    ):
        sched = _resolve_scheduler(scheduler, total_kv, decode_rate)
        self.sim = ClusterSim(
            sched,
            total_kv,
            decode_rate=decode_rate,
            prefill_rate=prefill_rate,
            swap_penalty=swap_penalty,
            token_events=token_events,
            prefix_cache=prefix_cache,
            admission_watermark=admission_watermark,
            suspend_retention=suspend_retention,
            retain_results=retain_results,
        )
        self.scheduler = sched

    @property
    def now(self) -> float:
        return self.sim.t

    @property
    def virtual_capacity(self) -> float:
        # pool size (KV tokens) x decode rate = KV token-time per second
        return self.sim.m * self.sim.decode_rate

    @property
    def in_flight(self) -> int:
        """Agents submitted but not completed (the sim's own live counter)."""
        return self.sim.live_agents

    def set_listener(self, listener: Any) -> None:
        self.sim.listener = listener

    def to_workload_time(self, t: float) -> float:
        return float(t)

    def submit(self, spec: AgentSpec, agent_id: int) -> float:
        pred, true = spec.resolved_costs()
        return self.sim.submit(
            SimAgent(
                agent_id=agent_id,
                arrival=float(spec.arrival),
                stages=[list(s) for s in spec.stages],
                predicted_cost=pred,
                true_cost=true,
                family=spec.family,
                name=spec.name,
                prefix_group=spec.prefix_group,
                shared_prefix=float(spec.shared_prefix),
                cached_hints=(
                    None
                    if spec.cached_hints is None
                    else [list(h) for h in spec.cached_hints]
                ),
            )
        )

    def submit_stage(
        self,
        agent_id: int,
        specs: Sequence[InferenceSpec],
        *,
        prompt_ids: Optional[Sequence[np.ndarray]] = None,
        hints: Optional[Sequence[float]] = None,
        resume_delay: Optional[float] = None,
    ) -> None:
        # the sim's analytic cache model needs only the hints; canonical
        # prompt ids are an engine-side concern
        self.sim.append_stage(
            agent_id,
            [list(specs)],
            hints=None if hints is None else [list(hints)],
            resume_delay=0.0 if resume_delay is None else float(resume_delay),
        )

    def cancel(self, agent_id: int) -> bool:
        return self.sim.cancel(agent_id)

    def run(self, until: float) -> None:
        # stale horizons (at-or-before the clock) are no-ops by the sim's
        # own contract: advance() only raises the clock floor
        self.sim.advance(until)

    def drain(self) -> BackendResult:
        res = self.sim.drain()
        return BackendResult(
            finish=dict(res.finish),
            jct=dict(res.jct),
            makespan=res.makespan,
            swaps=res.swaps,
            sched_decisions=res.sched_decisions,
            sched_time=res.sched_time,
            metrics={
                "swaps": res.swaps,
                "events": res.events,
                "key_evals": res.key_evals,
                "sorts": res.sorts,
                "peak_occupancy": res.peak_occupancy,
                "admission_deferrals": res.admission_deferrals,
                "wm_admit_peak": res.wm_admit_peak,
                "wm_bypass_admits": res.wm_bypass_admits,
                "prefill_tokens_saved": res.prefill_tokens_saved,
                "hit_fractions": self.sim.hit_fractions(),
                "suspensions": res.suspensions,
                "resumes": res.resumes,
                "suspend_spills": res.suspend_spills,
                "held_peak": res.held_peak,
            },
        )


class EngineBackend:
    """Real PyTorch continuous-batching engine behind the ``Backend``
    protocol (the port's ``ServeEngine``, on the device the model lives on).

    ``token_scale`` divides the workload's token demands down to engine
    scale (predicted KV token-time costs scale by ``token_scale**2`` since
    cost is quadratic-ish in token counts); ``time_scale`` maps workload
    seconds onto engine iterations for arrival scheduling and converts
    event/finish stamps back.
    """

    name = "engine"

    def __init__(
        self,
        model,
        params,
        scheduler: "str | AgentScheduler" = "justitia",
        *,
        pool_tokens: int = 4096,
        block_size: int = 16,
        max_batch: int = 8,
        cache_len: int = 512,
        prefill_chunk: int = 512,
        max_window: int = 32,
        token_scale: int = 1,
        time_scale: float = 1.0,
        seed: int = 0,
        max_iters: int = 200_000,
        prefix_cache: bool = False,
        fused_prefill: bool = False,
        admission_watermark: Optional[tuple] = None,
        suspend_retention: str = "hold",
    ):
        sched = _resolve_scheduler(scheduler, float(pool_tokens), 1.0)
        self.engine = ServeEngine(
            model,
            params,
            sched,
            pool_tokens=pool_tokens,
            block_size=block_size,
            max_batch=max_batch,
            cache_len=cache_len,
            prefill_chunk=prefill_chunk,
            max_window=max_window,
            prefix_cache=prefix_cache,
            fused_prefill=fused_prefill,
            admission_watermark=admission_watermark,
            suspend_retention=suspend_retention,
            device=model.device,
        )
        self.scheduler = sched
        self.token_scale = int(token_scale)
        self.time_scale = float(time_scale)
        self.max_iters = int(max_iters)
        self.pool_tokens = int(pool_tokens)
        self._vocab = int(model.cfg.vocab)
        self._rng = np.random.default_rng(seed)

    @property
    def now(self) -> float:
        return self.engine.now / self.time_scale

    @property
    def virtual_capacity(self) -> float:
        # engine pool tokens serve workload costs divided by token_scale**2
        # at time_scale iterations per workload second
        return self.pool_tokens * self.token_scale**2 * self.time_scale

    @property
    def in_flight(self) -> int:
        """Agents submitted but not completed (mirrors SimBackend's) —
        load-aware routers and the fleet watchdog's diagnostics read it."""
        eng = self.engine
        return (len(eng.agents) + len(eng.pending)) - len(eng.completions)

    def set_listener(self, listener: Any) -> None:
        self.engine.listener = listener

    def to_workload_time(self, t: float) -> float:
        return float(t) / self.time_scale

    def _scale_spec(
        self, s: InferenceSpec, prompt=None
    ) -> tuple[np.ndarray, int]:
        """One full-scale spec -> (engine prompt, scaled decode budget).

        Decode budgets always come from the (full-scale) spec and are
        scaled down; a pinned ``prompt`` is used verbatim (engine tokens
        already), otherwise one is synthesized at the scaled length.  The
        ONE scaling rule for opening stages and closed-loop follow-ups
        alike — the cross-backend token-count conformance pin depends on
        both paths rounding identically.
        """
        d = max(1, int(round(s.decode / self.token_scale)))
        if prompt is None:
            p = max(1, int(round(s.prefill / self.token_scale)))
            prompt = self._rng.integers(0, self._vocab, size=p)
        else:
            prompt = np.asarray(prompt)
        return prompt, d

    def _canon_prompt(self, s: InferenceSpec, ids) -> np.ndarray:
        """Canonical full-scale token ids -> engine prompt.

        Engine token ``k`` is canonical token ``k * token_scale``
        (stride subsampling), folded into the engine vocab.  The stride
        — not a head slice of the scaled length — is what keeps scaled
        prompts faithful: two canonical streams sharing an L-token
        prefix map to engine prompts sharing a ``~L / token_scale``
        prefix (matching ``_scale_hints``), and a prompt that is 60%
        shared content at full scale stays 60% shared at engine scale.
        A head slice would instead keep only the stream's head — at
        scale 8 every chat prompt up to 2048 canonical tokens would
        collapse into the family's 256-id system prefix, making all
        sessions' engine prompts identical.  The stream must be at
        least ``prefill`` ids long (the sessions guarantee it).
        """
        p = max(1, int(round(s.prefill / self.token_scale)))
        return np.asarray(ids)[:: self.token_scale][:p] % self._vocab

    def _stage_prompt(
        self, spec: AgentSpec, i: int, j: int, s: InferenceSpec
    ) -> Optional[np.ndarray]:
        if spec.prompts is not None:
            return spec.prompts[i][j]
        if spec.prompt_ids is not None:
            return self._canon_prompt(s, spec.prompt_ids[i][j])
        return None

    def _engine_stages(
        self, spec: AgentSpec
    ) -> list[list[tuple[np.ndarray, int]]]:
        return [
            [
                self._scale_spec(s, self._stage_prompt(spec, i, j, s))
                for j, s in enumerate(stage)
            ]
            for i, stage in enumerate(spec.stages)
        ]

    def _scale_hints(self, hints) -> Optional[list]:
        """Full-scale cached-prefix hints -> engine-token hints."""
        if hints is None:
            return None
        return [
            None if h is None else float(h) / self.token_scale
            for h in hints
        ]

    def submit(self, spec: AgentSpec, agent_id: int) -> float:
        pred, _ = spec.resolved_costs()
        arrival_iter = max(
            self.engine.now, int(round(spec.arrival * self.time_scale))
        )
        self.engine.submit_agent(
            EngineAgent(
                agent_id=agent_id,
                arrival_iter=arrival_iter,
                stages=self._engine_stages(spec),
                predicted_cost=pred / (self.token_scale * self.token_scale),
                closed_loop=spec.next_stage is not None,
                hints=(
                    None
                    if spec.cached_hints is None
                    else [self._scale_hints(h) for h in spec.cached_hints]
                ),
            )
        )
        return arrival_iter / self.time_scale

    def submit_stage(
        self,
        agent_id: int,
        specs: Sequence[InferenceSpec],
        *,
        prompt_ids: Optional[Sequence[np.ndarray]] = None,
        hints: Optional[Sequence[float]] = None,
        resume_delay: Optional[float] = None,
    ) -> None:
        """Append a follow-up stage to a live agent (closed-loop pacing).

        Token demands are scaled exactly like ``submit``'s; prompts come
        from ``prompt_ids`` (canonical full-scale streams, converted as
        in ``AgentSpec.prompt_ids``) or are synthesized from the
        backend's RNG.  Legal from inside an ``on_stage_complete``
        callback: the engine emits it before the stage-exhaustion check,
        and its fused decode windows already end at every closed-loop
        agent's stage boundary, so the appended stage is admitted at the
        next iteration — the same cadence the per-step reference engine
        would give it.
        """
        self.engine.append_stage(
            agent_id,
            [
                self._scale_spec(
                    s,
                    None
                    if prompt_ids is None
                    else self._canon_prompt(s, prompt_ids[j]),
                )
                for j, s in enumerate(specs)
            ],
            hints=self._scale_hints(hints),
            # a positive workload-seconds delay maps to >= 1 iteration so
            # a think time shorter than one engine tick still suspends
            resume_delay=(
                None
                if resume_delay is None or resume_delay <= 0.0
                else max(1, int(round(resume_delay * self.time_scale)))
            ),
        )

    def cancel(self, agent_id: int) -> bool:
        return self.engine.cancel(agent_id)

    def run(self, until: float) -> None:
        # ceil (with an fp guard): run must advance AT LEAST to `until`, or
        # a fleet's post-drain re-anchor could leave this engine's clock
        # trailing the reconciled horizon by a fraction of an iteration.
        # But a horizon at-or-before the current clock must be a NO-OP:
        # ceil lands one iteration PAST the clock when `until * time_scale`
        # floats a hair above the integer `now` (stale-target regression)
        if until <= self.now:
            return
        self.engine.run(math.ceil(until * self.time_scale - 1e-9))

    def drain(self) -> BackendResult:
        completions = self.engine.run_until_idle(max_iters=self.max_iters)
        self.engine.alloc.check_invariants()
        metrics = dict(self.engine.metrics)
        metrics["hit_fractions"] = self.engine.hit_fractions()
        finish = {
            aid: it / self.time_scale for aid, it in completions.items()
        }
        jct = {
            aid: (completions[aid] - self.engine.agents[aid].arrival_iter)
            / self.time_scale
            for aid in completions
        }
        return BackendResult(
            finish=finish,
            jct=jct,
            makespan=self.now,
            swaps=self.engine.metrics["swaps"],
            metrics=metrics,
        )
