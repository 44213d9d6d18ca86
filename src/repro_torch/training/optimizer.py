"""AdamW from scratch with a linear-warmup cosine decay: the port's
counterpart of ``repro.training.optimizer``.

State mirrors the params (m, v in float32) plus a scalar step, in an
``AdamState`` whose field names make the checkpoint keys the JAX package
writes (``opt/.step``, ``opt/.m/...``, ``opt/.v/...``).  Trees are nested
dicts and lists of tensors, as the port's parameters are.

Where JAX returns new arrays, ``adamw_update`` updates the parameters and
moments in place, one leaf at a time under ``torch.no_grad()``: at full
width a stacked leaf is 671 M elements, 2.7 GB per float32 temporary, so
only one leaf's temporaries exist at once.

The trees may hold DTensors (a sharded plan): each leaf's update runs on
its shards, the moments laid out as the parameters (ZeRO), and the global
norm sums the leaves' squares as plain scalars on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor         # () int32
    m: Any                     # tree like params, float32
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def init_adamw(params) -> AdamState:
    leaf = tree_leaves(params)[0]
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        m=tree_map(_zeros_f32, params),
        v=tree_map(_zeros_f32, params),
    )


def lr_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int tensor), float32."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(1, cfg.total_steps - cfg.warmup_steps),
        0.0,
        1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _square_sum(x):
    """sum(x^2) of one leaf; a DTensor leaf's sum is reduced to a plain
    scalar on every rank (a collective every rank calls, leaf by leaf)."""
    s = torch.sum(torch.square(x.float()))
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tree):
    return torch.sqrt(sum(_square_sum(x) for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamState, params):
    """Returns (params, new_state, metrics); ``params`` and the moments are
    updated in place (the returned trees are the ones passed in)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step_f = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, device=step.device) ** step_f
    bc2 = 1 - torch.tensor(cfg.b2, device=step.device) ** step_f
    lr = lr_schedule(cfg, step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        u += cfg.weight_decay * p32
        p.copy_(p32 - lr * u)
        del u, p32
    return params, AdamState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm,
        "lr": lr,
    }
