"""Unified serving API: one facade over the simulator and the port's
PyTorch engine (a copy of the JAX package's ``repro.api``).

    from repro_torch.api import AgentService, AgentSpec

    service = AgentService.sim(scheduler="justitia")          # or .engine(...)
    handle = service.submit(AgentSpec(stages=[[InferenceSpec(300, 80)]]))
    result = service.drain()

See ``repro.api.service`` for the facade, ``repro.api.backend`` for the
``Backend`` protocol and how to add a backend, ``repro.api.events`` for the
streamed lifecycle events, and ``repro.core.registry`` for the scheduler
plugin registry the facade resolves policy names through.
"""

from repro_torch.api.backend import (
    AgentSpec,
    Backend,
    BackendResult,
    EngineBackend,
    SimBackend,
)
from repro_torch.api.events import (
    AdmissionDeferred,
    AgentArrived,
    AgentCompleted,
    AgentEvent,
    AgentHooks,
    AgentRequeued,
    AgentResumed,
    AgentSuspended,
    PrefixHit,
    ReplicaFailed,
    ReplicaRecovered,
    RequestAdmitted,
    RequestSwappedIn,
    RequestSwappedOut,
    StageCompleted,
    StageOutcome,
    TokenGenerated,
)
from repro_torch.api.faults import Fault, FaultPlan
from repro_torch.api.replicated import (
    FleetStalledError,
    ReplicatedBackend,
    Router,
    register_router,
    resolve_router,
    router_names,
)
from repro_torch.api.service import (
    AgentHandle,
    AgentService,
    MetricsRecorder,
    ServiceResult,
)
from repro_torch.api.workload import (
    service_for_backend,
    specs_from_classes,
    specs_from_closed_loop,
)

__all__ = [
    "AgentSpec",
    "Backend",
    "BackendResult",
    "EngineBackend",
    "SimBackend",
    "AdmissionDeferred",
    "AgentArrived",
    "AgentCompleted",
    "AgentEvent",
    "AgentHooks",
    "AgentRequeued",
    "AgentResumed",
    "AgentSuspended",
    "PrefixHit",
    "ReplicaFailed",
    "ReplicaRecovered",
    "RequestAdmitted",
    "RequestSwappedIn",
    "RequestSwappedOut",
    "StageCompleted",
    "StageOutcome",
    "TokenGenerated",
    "AgentHandle",
    "AgentService",
    "MetricsRecorder",
    "ServiceResult",
    "Fault",
    "FaultPlan",
    "FleetStalledError",
    "ReplicatedBackend",
    "Router",
    "register_router",
    "resolve_router",
    "router_names",
    "specs_from_classes",
    "specs_from_closed_loop",
    "service_for_backend",
]
