"""Architecture registry of the port: ``get_config(arch_id)`` + input shapes.

A copy of the JAX package's registry (pure data): every arch of the
reference, in its order and under its ids.  Every entry cites its source
in the module docstring.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "whisper-tiny": "whisper_tiny",
    "granite-3-2b": "granite_3_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "dbrx-132b": "dbrx_132b",
    "llava-next-34b": "llava_next_34b",
    "xlstm-350m": "xlstm_350m",
    "zamba2-2.7b": "zamba2_2_7b",
    "starcoder2-7b": "starcoder2_7b",
    "llama2-7b": "llama2_7b_paper",
}

ASSIGNED_ARCHS = [k for k in _MODULES if k != "llama2-7b"]
ALL_ARCHS = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, *, shape: str | None = None) -> ModelConfig:
    """Resolve an arch id (optionally specialized for an input shape).

    ``shape='long_500k'`` applies the arch's LONG_CONTEXT_OVERRIDES (e.g.
    the sliding-window decode variant for dense archs).  Raises ValueError
    if the arch skips that shape (whisper x long_500k).
    """
    mod = _module(arch)
    cfg: ModelConfig = mod.CONFIG
    if shape == "long_500k":
        over = getattr(mod, "LONG_CONTEXT_OVERRIDES", {})
        if over is None:
            raise ValueError(
                f"{arch} skips long_500k (see DESIGN.md §4 skip notes)"
            )
        if over:
            cfg = dataclasses.replace(cfg, **over)
    return cfg


def supports_shape(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return getattr(_module(arch), "LONG_CONTEXT_OVERRIDES", {}) is not None
    return True


__all__ = [
    "ALL_ARCHS",
    "ASSIGNED_ARCHS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
    "supports_shape",
]
