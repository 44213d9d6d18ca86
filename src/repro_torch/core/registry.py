"""Scheduler plugin registry and the typed ``SchedulerPolicy`` contract.

The backend/scheduler contract that ``AgentScheduler`` implied informally is
formalized here as a ``typing.Protocol``: a policy is anything that accepts
agent arrival/completion/service notifications and answers ``request_key``
queries.  Policies register themselves by name::

    @register_scheduler("justitia")
    class JustitiaScheduler(AgentScheduler):
        ...

and every consumer — the simulator, the engine, ``AgentService``, the
benchmarks — resolves names through :func:`resolve_scheduler` /
``make_scheduler`` instead of a hard-coded if-chain.  ``ALL_SCHEDULERS`` is
derived from the registry, so a policy added by a plugin module shows up in
sweeps automatically.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.schedulers import Request


@runtime_checkable
class SchedulerPolicy(Protocol):
    """What a backend requires of a scheduling policy.

    Lifecycle: the backend calls ``on_agent_arrival`` exactly once per agent,
    ``on_service`` as service is dealt, and ``on_agent_complete`` once when
    the agent's last inference finishes.  Decisions: ``request_key`` returns
    a totally-ordered key (lower = served first) for a pending request at
    time ``t``; it must be pure (no state mutation).  ``dynamic`` declares
    whether keys can change between calls with identical arguments — static
    policies (``dynamic = False``) allow backends to keep their queues
    incrementally sorted instead of re-sorting at every decision.

    Two OPTIONAL performance attributes (not required members of this
    protocol — the backends degrade gracefully via ``getattr`` when they
    are absent, and ``AgentScheduler`` subclasses get both for free):
    ``version`` is a mutation counter gating queue re-sorts under dynamic
    policies — bump it whenever state that ``request_key`` reads changes;
    absent, dirty queues re-sort every admission pass.  ``agent_keyed``
    declares that a dynamic key reads nothing beyond the request and its
    own agent's record, unlocking grouped queue invalidation (see
    ``repro.core.queueing`` and ROADMAP "Scheduler-plugin invariants");
    absent, it is taken as False.
    """

    name: str
    dynamic: bool

    def on_agent_arrival(
        self, agent_id: int, t: float, predicted_cost: float
    ) -> None: ...

    def on_agent_complete(self, agent_id: int, t: float) -> None: ...

    def on_service(
        self,
        agent_id: int,
        *,
        kv_token_time: float = 0.0,
        prefill_tokens: float = 0.0,
        decode_tokens: float = 0.0,
        w_p: float = 1.0,
        w_d: float = 2.0,
    ) -> None: ...

    def request_key(self, req: "Request", t: float) -> tuple: ...


_REGISTRY: dict[str, type] = {}
_ALIASES: dict[str, str] = {}


def register_scheduler(name: str, *aliases: str):
    """Class decorator: register a :class:`SchedulerPolicy` under ``name``.

    ``name`` becomes the canonical entry (listed by :func:`scheduler_names`);
    ``aliases`` resolve to the same class but are not listed.  Registering a
    duplicate canonical name or alias raises ``ValueError`` so two plugins
    cannot silently shadow each other.
    """

    canonical = name.lower()

    def deco(cls: type) -> type:
        # validate every name before mutating anything, so a collision
        # cannot leave a half-registered plugin behind
        if canonical in _REGISTRY or canonical in _ALIASES:
            raise ValueError(f"scheduler {canonical!r} already registered")
        lowered = [a.lower() for a in aliases]
        for alias in lowered:
            if alias in _REGISTRY or alias in _ALIASES:
                raise ValueError(f"scheduler alias {alias!r} already taken")
        _REGISTRY[canonical] = cls
        cls.name = canonical
        for alias in lowered:
            _ALIASES[alias] = canonical
        return cls

    return deco


def unregister_scheduler(name: str) -> None:
    """Remove a canonical registration and its aliases (test plumbing)."""
    canonical = name.lower()
    _REGISTRY.pop(canonical, None)
    for alias in [a for a, c in _ALIASES.items() if c == canonical]:
        del _ALIASES[alias]


def resolve_scheduler(name: str) -> type:
    """Name (or alias) -> registered policy class; ValueError if unknown."""
    key = name.lower()
    key = _ALIASES.get(key, key)
    try:
        return _REGISTRY[key]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise ValueError(
            f"unknown scheduler {name!r} (registered: {known})"
        ) from None


def scheduler_names() -> list[str]:
    """Canonical names in registration order (drives benchmark sweeps)."""
    return list(_REGISTRY)
