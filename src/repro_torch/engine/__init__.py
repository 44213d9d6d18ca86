"""Continuous-batching serving engine of the port (vLLM semantics, PyTorch
device path)."""

from repro_torch.engine.engine import (
    EngineAgent,
    EngineRequest,
    EngineStalledError,
    ServeEngine,
)

__all__ = [
    "EngineAgent",
    "EngineRequest",
    "EngineStalledError",
    "ServeEngine",
]
