"""Continuous-batching serving engine of the port (vLLM semantics, PyTorch
device path), and the frozen pre-rewrite engine it is pinned against."""

from repro_torch.engine.engine import (
    EngineAgent,
    EngineRequest,
    EngineStalledError,
    ServeEngine,
)
from repro_torch.engine.reference import ReferenceServeEngine

__all__ = [
    "EngineAgent",
    "EngineRequest",
    "EngineStalledError",
    "ReferenceServeEngine",
    "ServeEngine",
]
