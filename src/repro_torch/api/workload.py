"""Shared workload/service builders for the CLI launchers and examples.

Both ``repro.launch.serve`` and ``examples/serve_agents.py`` stream the
paper's sampled agent classes into an :class:`AgentService` with bursty
(Mooncake-like) arrival times; the spec construction and the sim-vs-engine
service wiring live here so calibration constants exist in exactly one
place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.api.backend import AgentSpec
from repro_torch.api.service import AgentService
from repro_torch.workloads import (
    CLOSED_LOOP_CLASSES,
    mooncake_like_arrivals,
    sample_agent,
    sample_closed_loop,
)

#: default small-agent mix used by the CLI drivers
DEFAULT_CLASSES = ("EV", "FV", "CC", "KBQAV")

#: default closed-loop session mix (multi-turn chat + react tool loops).
#: Think-time-heavy families are EXCLUDED from the default: they suspend
#: agents mid-run, which would silently change every CLI/benchmark run
#: that relies on the default mix — opt in with ``--closed-loop-classes``
#: or an explicit ``classes=`` list (e.g. ``("tooluse",)``)
DEFAULT_CLOSED_LOOP = tuple(
    name for name, c in CLOSED_LOOP_CLASSES.items() if c.think[1] <= 0.0
)

#: engine serves token demands divided by this (predicted costs by its
#: square, since KV token-time is ~quadratic in token counts)
DEFAULT_TOKEN_SCALE = 8


def specs_from_classes(
    rng: np.random.Generator,
    n_agents: int,
    window_s: float,
    *,
    classes: Sequence[str] = DEFAULT_CLASSES,
    predictor=None,
) -> list[AgentSpec]:
    """Sample one backend-agnostic AgentSpec list with online arrivals.

    ``predictor`` (an ``AgentCostPredictor``) supplies predicted costs from
    each agent's synthetic prompt; without one, ground-truth costs are used.
    """
    arrivals = mooncake_like_arrivals(rng, n_agents, window_s)
    specs = []
    for aid in range(n_agents):
        cls = classes[aid % len(classes)]
        a = sample_agent(rng, cls)
        pred = (
            float(predictor.predict(cls, a.prompt))
            if predictor is not None
            else a.true_cost
        )
        specs.append(
            AgentSpec(
                stages=[list(s) for s in a.stages],
                arrival=float(arrivals[aid]),
                predicted_cost=pred,
                true_cost=a.true_cost,
                name=cls,
            )
        )
    return specs


def specs_from_closed_loop(
    rng: np.random.Generator,
    n_agents: int,
    window_s: float,
    *,
    classes: Sequence[str] = DEFAULT_CLOSED_LOOP,
) -> list[AgentSpec]:
    """Sample a closed-loop AgentSpec list (multi-turn chat / react loops).

    Each spec carries only its opening turn in ``stages`` plus a stateful
    ``next_stage`` session callback that generates later turns as earlier
    ones complete.  Sessions hold mutable turn state, so the list is
    SINGLE-USE: rebuild (same seed) for every serving run rather than
    resubmitting — unlike the open-loop specs, these cannot be shared
    across runs.

    Specs carry the sessions' prefix-cache metadata: canonical prompt
    token streams (``prompt_ids``), per-inference expected cached-prefix
    hints (``cached_hints``), and the family's shared system prefix
    (``prefix_group``/``shared_prefix``) — inert on cache-oblivious
    backends, exploited by ones built with ``prefix_cache=True``.
    """
    arrivals = mooncake_like_arrivals(rng, n_agents, window_s)
    specs = []
    for aid in range(n_agents):
        cls = classes[aid % len(classes)]
        session = sample_closed_loop(rng, cls)
        specs.append(
            AgentSpec(
                stages=[list(session.first_stage)],
                arrival=float(arrivals[aid]),
                predicted_cost=session.expected_cost,
                true_cost=session.expected_cost,
                name=cls,
                next_stage=session,
                prompt_ids=(
                    None
                    if session.last_prompt_ids is None
                    else [list(session.last_prompt_ids)]
                ),
                cached_hints=[list(session.last_cached_hints)],
                prefix_group=cls,
                shared_prefix=float(session.cls.sys_prefix),
            )
        )
    return specs


def service_for_backend(
    backend: str,
    scheduler: str,
    *,
    arch: str = "granite-3-2b",
    vocab: int = 512,
    pool_tokens: int = 4096,
    max_batch: int = 4,
    cache_len: int = 512,
    token_scale: int = DEFAULT_TOKEN_SCALE,
    sim_kv_factor: float = 4.0,
    decode_rate: float = 30.0,
    seed: int = 0,
    replicas: int = 1,
    router: str = "round_robin",
    stream: bool = False,
    prefix_cache: bool = False,
    fused_prefill: bool = False,
    fault_plan=None,
    watchdog_timeout: Optional[float] = None,
    watchdog_retries: Optional[int] = None,
    watchdog_backoff: Optional[float] = None,
    admission_watermark: Optional[tuple] = None,
    suspend_retention: Optional[str] = None,
    think_time_accrual: bool = True,
    fleet_workers: Optional[int] = None,
    steal_threshold: Optional[float] = None,
    steal_interval: Optional[float] = None,
    device=None,
) -> AgentService:
    """Build an AgentService for ``backend`` in {"sim", "engine"}.

    ``device`` places the engine's model: ``cuda`` unless the caller names
    another (``"cpu"``); with no device named and no CUDA device present
    the engine branch raises, as every entry point of the port does.  The
    sim ignores it.

    The sim pool is ``pool_tokens * sim_kv_factor`` KV units: the simulator
    serves full-scale token demands while the engine serves them divided by
    ``token_scale``, so its pool is proportionally wider.

    ``replicas > 1`` shards the fleet behind a
    :class:`repro.api.ReplicatedBackend` using ``router`` (a name from
    ``repro.api.router_names()``); ``pool_tokens`` stays *per replica*, so
    raising ``replicas`` adds capacity rather than splitting it.

    ``stream=True`` asks for per-token events on every backend: the engine
    always streams its sampled tokens; the sim turns on its discretized
    ``token_events`` decode model (off by default — the emission sweep
    costs O(running) per event).

    ``prefix_cache=True`` turns on prefix-aware KV reuse on both
    backends (the engine's content-hash block index / the sim's analytic
    hit model) — per-agent hit fractions and ``prefill_tokens_saved``
    land in the drained result's ``metrics``.

    ``fused_prefill=True`` (engine only; ignored by the sim, whose
    analytic prefill never stalls decoders) streams each admitted
    prompt's uncached suffix into the fused decode windows one
    ``prefill_chunk`` slice per iteration instead of charging a blocking
    whole-prefill pass at admission — the interference-aware batch
    formation path.

    ``fault_plan`` (a :class:`repro.api.FaultPlan`) plus
    ``watchdog_timeout`` arm deterministic fault injection and failover
    on the fleet — both require ``replicas > 1``; ``watchdog_retries`` /
    ``watchdog_backoff`` tune the suspect-probe schedule (backend
    defaults apply when ``None``).
    ``admission_watermark=(low, high)`` (pool fractions) turns on
    watermark admission control on every child backend.

    ``suspend_retention`` in {"hold", "spill", "drop"} picks what happens
    to a suspended agent's KV during tool-call think time (``None`` keeps
    the backend default, "hold"); ``think_time_accrual=False`` removes
    thinking agents from the fleet's GPS reference so think time accrues
    no virtual time (the default True is the paper's stance).

    ``fleet_workers > 1`` advances the fleet's children concurrently on a
    bounded thread pool (bit-identical to the sequential lockstep loop —
    see :class:`repro.api.ReplicatedBackend`); ``steal_threshold`` arms
    load-triggered work stealing of queued, never-admitted agents at
    every ``steal_interval`` workload-seconds.  All three require
    ``replicas > 1``.
    """
    fleet_kw = {}
    if fault_plan is not None:
        fleet_kw["fault_plan"] = fault_plan
    if watchdog_timeout is not None:
        fleet_kw["watchdog_timeout"] = watchdog_timeout
    if watchdog_retries is not None:
        fleet_kw["watchdog_retries"] = int(watchdog_retries)
    if watchdog_backoff is not None:
        fleet_kw["watchdog_backoff"] = float(watchdog_backoff)
    if not think_time_accrual:
        fleet_kw["think_time_accrual"] = False
    if fleet_workers is not None:
        fleet_kw["fleet_workers"] = int(fleet_workers)
    if steal_threshold is not None:
        fleet_kw["steal_threshold"] = float(steal_threshold)
    if steal_interval is not None:
        fleet_kw["steal_interval"] = float(steal_interval)
    child_kw = {}
    if suspend_retention is not None:
        child_kw["suspend_retention"] = suspend_retention
    if backend == "sim":
        return AgentService.sim(
            scheduler,
            total_kv=float(pool_tokens) * sim_kv_factor,
            decode_rate=decode_rate,
            replicas=replicas, router=router, seed=seed,
            token_events=stream,
            prefix_cache=prefix_cache,
            admission_watermark=admission_watermark,
            **child_kw,
            **fleet_kw,
        )
    if backend != "engine":
        raise ValueError(f"unknown backend {backend!r} (sim|engine)")
    from repro_torch.configs import get_config
    from repro_torch.engine.engine import check_servable
    from repro_torch.models import Model

    cfg = get_config(arch).reduced(vocab=vocab)
    check_servable(cfg)
    model = Model(cfg, device=device)
    params = model.init(seed=seed)
    return AgentService.engine(
        model, params, scheduler,
        pool_tokens=pool_tokens, max_batch=max_batch, cache_len=cache_len,
        token_scale=token_scale, time_scale=1.0,
        replicas=replicas, router=router, seed=seed,
        prefix_cache=prefix_cache, fused_prefill=fused_prefill,
        admission_watermark=admission_watermark,
        **child_kw,
        **fleet_kw,
    )
