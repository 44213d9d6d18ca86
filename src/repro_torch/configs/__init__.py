"""Architecture registry of the port: ``get_config(arch_id)`` + input shapes.

A copy of the JAX package's registry (pure data), holding the archs the
port serves so far.  Every entry cites its source in the module docstring.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "granite-3-2b": "granite_3_2b",
}

ALL_ARCHS = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, *, shape: str | None = None) -> ModelConfig:
    """Resolve an arch id (optionally specialized for an input shape).

    ``shape='long_500k'`` applies the arch's LONG_CONTEXT_OVERRIDES (e.g.
    the sliding-window decode variant for dense archs).
    """
    mod = _module(arch)
    cfg: ModelConfig = mod.CONFIG
    if shape == "long_500k":
        over = getattr(mod, "LONG_CONTEXT_OVERRIDES", {})
        if over is None:
            raise ValueError(f"{arch} skips long_500k")
        if over:
            cfg = dataclasses.replace(cfg, **over)
    return cfg


__all__ = [
    "ALL_ARCHS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
]
