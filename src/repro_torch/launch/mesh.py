"""Production mesh builders: the port's counterpart of
``repro.launch.mesh``.

The JAX package's target is TPU v5e pods, 16x16 = 256 chips per pod
("data" x "model"), and 2 pods = 512 chips with a leading "pod" axis.  The
port builds the same meshes as ``DeviceMesh``es over the ranks of the
default process group: real ranks under ``torchrun``, or the fake ranks of
the dry-run (``launch/dryrun.py``), which run no collective.

Functions, not module constants: importing this module never touches
``torch.distributed`` state; process groups are made by the callers.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def production_layout(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return MULTI_POD_SHAPE, MULTI_POD_AXES
    return PRODUCTION_SHAPE, PRODUCTION_AXES


def _make(shape: tuple, axes: tuple, device_type: str):
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks; none is "
            "initialised"
        )
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, the process group has {world}"
        )
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``; raises RuntimeError unless the default process
    group has exactly that many ranks."""
    shape, axes = production_layout(multi_pod)
    return _make(shape, axes, device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cuda"):
    """Small mesh for sharding tests and the debug launcher (the process
    group's world size must match)."""
    return _make(tuple(shape), tuple(axes), device_type)
