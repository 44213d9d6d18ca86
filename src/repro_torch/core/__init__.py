"""Justitia core (copy of the JAX package's pure-Python core): cost model,
virtual-time fair queuing, and the schedulers."""

from repro_torch.core.cost import (
    InferenceSpec,
    MemoryFamily,
    agent_cost,
    encdec_kv_token_time,
    hybrid_kv_token_time,
    inference_cost,
    kv_token_time,
    ssm_token_time,
    swa_kv_token_time,
    vtc_agent_cost,
    vtc_cost,
)
from repro_torch.core.gps import GpsAgent, gps_finish_times, gps_finish_times_fluid
from repro_torch.core.queueing import OrderedQueue
from repro_torch.core.registry import (
    SchedulerPolicy,
    register_scheduler,
    resolve_scheduler,
    scheduler_names,
    unregister_scheduler,
)
from repro_torch.core.schedulers import (
    AgentRecord,
    AgentScheduler,
    JustitiaScheduler,
    ParrotScheduler,
    Request,
    SrjfScheduler,
    VllmFcfsScheduler,
    VllmSjfScheduler,
    VtcScheduler,
    make_scheduler,
)
from repro_torch.core.virtual_time import (
    GlobalClockSnapshot,
    GlobalVirtualClock,
    VirtualClock,
)


def __getattr__(attr: str):
    # live view of the registry (see repro.core.schedulers.__getattr__)
    if attr == "ALL_SCHEDULERS":
        return scheduler_names()
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


__all__ = [
    "InferenceSpec",
    "MemoryFamily",
    "agent_cost",
    "encdec_kv_token_time",
    "hybrid_kv_token_time",
    "inference_cost",
    "kv_token_time",
    "ssm_token_time",
    "swa_kv_token_time",
    "vtc_agent_cost",
    "vtc_cost",
    "GpsAgent",
    "gps_finish_times",
    "gps_finish_times_fluid",
    "OrderedQueue",
    "ALL_SCHEDULERS",
    "AgentRecord",
    "AgentScheduler",
    "JustitiaScheduler",
    "ParrotScheduler",
    "Request",
    "SrjfScheduler",
    "VllmFcfsScheduler",
    "VllmSjfScheduler",
    "VtcScheduler",
    "make_scheduler",
    "SchedulerPolicy",
    "register_scheduler",
    "resolve_scheduler",
    "scheduler_names",
    "unregister_scheduler",
    "GlobalClockSnapshot",
    "GlobalVirtualClock",
    "VirtualClock",
]
