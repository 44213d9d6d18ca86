"""Justitia core (copy of the JAX package's pure-Python core): cost model,
virtual-time fair queuing, and the schedulers."""

from repro_torch.core.cost import InferenceSpec, agent_cost, kv_token_time
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
from repro_torch.core.virtual_time import VirtualClock

__all__ = [
    "InferenceSpec",
    "agent_cost",
    "kv_token_time",
    "OrderedQueue",
    "SchedulerPolicy",
    "register_scheduler",
    "resolve_scheduler",
    "scheduler_names",
    "unregister_scheduler",
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
    "VirtualClock",
]
