"""Typed lifecycle events streamed by :class:`repro.api.AgentService`.

Both backends (the discrete-event simulator and the real JAX engine) emit
the same duck-typed callbacks; the service's dispatcher normalizes them into
these frozen dataclasses with ``time`` in *workload seconds* regardless of
the backend's native clock (the engine counts iterations internally).

``TokenGenerated`` is backend-uniform: the engine streams its actually
sampled token ids, and the simulator (with ``token_events=True`` on
``SimBackend``/``ClusterSim``) streams the discretized token boundaries
its closed-form decode implies, stamped at the exact boundary-crossing
instants, with the 0-based token index as the ``token`` value.  The
per-agent event order and the per-request token *counts* are identical
across backends (pinned by ``tests/test_event_conformance.py``); only the
token values differ (the sim samples none).

Every event carries a ``replica`` index when served through a
:class:`repro.api.ReplicatedBackend` (``None`` on single-backend services):
the fleet dispatcher tags each child backend's callbacks with the replica
that emitted them, so per-replica metrics fall out of the same stream.

``StageOutcome`` is the view handed to a closed-loop
:class:`repro.api.AgentSpec`'s ``next_stage`` callback after each stage
completes — see ``repro.api.service``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class AgentEvent:
    agent_id: int
    time: float
    #: which replica of a ReplicatedBackend served this (None: unreplicated)
    replica: Optional[int] = dataclasses.field(default=None, kw_only=True)


@dataclasses.dataclass(frozen=True)
class AgentArrived(AgentEvent):
    pass


@dataclasses.dataclass(frozen=True)
class RequestAdmitted(AgentEvent):
    rid: int


@dataclasses.dataclass(frozen=True)
class RequestSwappedOut(AgentEvent):
    rid: int


@dataclasses.dataclass(frozen=True)
class RequestSwappedIn(AgentEvent):
    rid: int


@dataclasses.dataclass(frozen=True)
class TokenGenerated(AgentEvent):
    rid: int
    token: int


@dataclasses.dataclass(frozen=True)
class PrefixHit(AgentEvent):
    """One admission reused ``cached`` of its ``prefill`` prompt tokens
    from the prefix cache (backend-native token scale; emitted only when
    the backend was built with ``prefix_cache=True`` and the hit is
    non-zero).  The engine reports the exact full-block match its
    allocator found; the simulator reports its analytic model's hit —
    identical by construction when prompts are block-aligned (pinned by
    the sim-vs-engine hit-fraction equivalence test)."""

    rid: int
    cached: int
    prefill: int


@dataclasses.dataclass(frozen=True)
class StageCompleted(AgentEvent):
    stage: int


@dataclasses.dataclass(frozen=True)
class AgentCompleted(AgentEvent):
    jct: float


@dataclasses.dataclass(frozen=True)
class ReplicaFailed(AgentEvent):
    """A fleet child was declared DEAD (``replica`` names it).  Fleet-
    scoped: emitted with ``agent_id=-1`` — no per-agent handle records it,
    but the service recorder counts it and listeners see it in-stream.
    ``reason`` distinguishes a planned crash from a watchdog timeout."""

    reason: str = ""


@dataclasses.dataclass(frozen=True)
class ReplicaRecovered(AgentEvent):
    """A child previously suspected stalled resumed progress before its
    watchdog budget ran out (fleet-scoped, ``agent_id=-1``)."""


@dataclasses.dataclass(frozen=True)
class AgentRequeued(AgentEvent):
    """The agent's remaining stages were failed over from a dead replica
    (``from_replica``) to a surviving one (``replica``).  Resets the
    agent's per-replica admit/swap chain in the conformance grammar; its
    accrued global virtual time carries over unchanged."""

    from_replica: int = -1


@dataclasses.dataclass(frozen=True)
class AgentSuspended(AgentEvent):
    """The agent entered think time after completing ``stage`` (a closed-
    loop ``resume_delay``): it holds no decode slot until ``until``
    (workload seconds), and its KV sits under the backend's
    ``suspend_retention`` policy (``hold``/``spill``/``drop``).  Between
    this event and the matching :class:`AgentResumed`, the agent admits
    nothing; a fleet may close the suspension with an
    :class:`AgentRequeued` instead when the suspending replica dies."""

    stage: int = -1
    until: float = 0.0


@dataclasses.dataclass(frozen=True)
class AgentResumed(AgentEvent):
    """Think time ended: the agent's next stage was (re-)submitted.
    Exactly one per :class:`AgentSuspended`, on the same replica — or at
    requeue time (old replica) when the suspension is closed by a
    failover migration."""


@dataclasses.dataclass(frozen=True)
class AdmissionDeferred(AgentEvent):
    """Watermark admission control held request ``rid`` back because
    occupancy sat above the high watermark (emitted at most once per
    request; the eventual ``RequestAdmitted`` follows once occupancy
    drains below the low watermark)."""

    rid: int = -1


@dataclasses.dataclass
class StageOutcome:
    """What a closed-loop ``AgentSpec.next_stage`` callback is fed.

    ``stage`` is the 0-based index of the stage that just completed;
    ``time`` its completion in workload seconds; ``new_tokens`` the number
    of ``TokenGenerated`` events observed for the agent since the previous
    stage boundary (0 when the backend does not stream tokens — sim with
    ``token_events=False``); ``handle`` the live :class:`AgentHandle`
    (events/tokens are retained on it when the service records events).

    ``new_tokens`` is in the backend's NATIVE token scale: full workload
    tokens on the sim, engine tokens (demand / ``token_scale``) on the
    engine.  A session whose control flow branches on it will therefore
    unfold differently across backends — the stock closed-loop families
    deliberately key only on their own turn counters (see ROADMAP
    "closed-loop clients"), which is what the cross-backend turn-count
    conformance pin relies on.

    The callback returns the next stage's ``InferenceSpec`` list, or
    ``None``/empty to let the agent complete.  It runs synchronously
    inside the backend's event loop and MUST NOT call ``run``/``drain``
    on the service (enforced) or submit new agents.
    """

    agent_id: int
    stage: int
    time: float
    new_tokens: int
    handle: Any


Hook = Optional[Callable[[AgentEvent], None]]


@dataclasses.dataclass
class AgentHooks:
    """Per-agent lifecycle callbacks, each invoked with the typed event.

    Any subset may be set; ``on_swap`` fires for both swap-out and swap-in
    (inspect the event type to distinguish).  ``on_token`` fires on the
    engine backend always and on the sim backend when it was built with
    ``token_events=True``.
    """

    on_admit: Hook = None
    on_swap: Hook = None
    on_stage_complete: Hook = None
    on_complete: Hook = None
    on_token: Hook = None
    #: fires on prefix-cache hits (backends built with ``prefix_cache=True``)
    on_prefix_hit: Hook = None
    #: fires when the agent is failed over to a surviving replica
    on_requeued: Hook = None
    #: fires when the agent enters think time (closed-loop ``resume_delay``)
    on_suspend: Hook = None
    #: fires when think time ends and the next stage is submitted
    on_resume: Hook = None
    #: fires when watermark admission control defers one of the agent's
    #: requests (backends built with ``admission_watermark=...``)
    on_defer: Hook = None
