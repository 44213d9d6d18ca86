"""Logical-axis sharding annotations: the port's counterpart of
``repro.models.shardlib``.

Model code annotates activations with *logical* axis names; the launcher
installs a ``DeviceMesh`` and a logical->mesh rule table.  A spec ``P`` is
a tuple with one entry per tensor dim: a mesh-axis name, ``None``
(replicated) or a tuple of names (split major to minor, as JAX splits).
``to_placements`` turns it into one DTensor placement per mesh dim, and
``shard`` redistributes a DTensor to it.  With no rules installed (unit
tests, one-device serving and training), or on a plain tensor, every
annotation is the identity, so the same model code serves one device and
the sharded plans.

``local_call`` runs a function on local shards (DTensor's ``local_map``):
the model's products, and the computations that are independent along a
few dims (the attention core, the MoE routing, the recurrences, the cache
writes), which the sharding propagation of DTensor's ops cannot follow
(a reshape that merges a sharded dim, a scatter into a sharded cache).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import _pytree as pytree

_state = threading.local()


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _current():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextlib.contextmanager
def use_sharding(mesh, rules: dict[str, object]):
    """rules: logical axis name -> mesh axis (str), tuple of axes, or None."""
    _current().append((mesh, dict(rules)))
    try:
        yield
    finally:
        _current().pop()


def active_rules():
    """``(mesh, rules)`` of the innermost ``use_sharding``, else None."""
    stack = _current()
    return stack[-1] if stack else None


def logical_to_spec(names: Sequence[Optional[str]], rules: dict) -> P:
    return P(*(None if n is None else rules.get(n) for n in names))


def to_placements(spec: Sequence, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` on every mesh dim that
    tensor dim d names (a tuple names several, which must come in mesh
    order: the first splits major), ``Replicate()`` on every other."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax!r} is not in mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} named twice in "
                                 f"{spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def shard(x, *names: Optional[str]):
    """Annotate ``x`` whose dims carry the given logical names: a DTensor
    is redistributed to the rules' placements (a collective where they
    differ from its own); a plain tensor passes through."""
    ctx = active_rules()
    if ctx is None:
        return x
    mesh, rules = ctx
    if x.ndim != len(names):
        raise ValueError(
            f"shard(): rank {x.ndim} array got {len(names)} logical names"
        )
    if not isinstance(x, DTensor):
        return x
    placements = to_placements(logical_to_spec(names, rules), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def param_spec(names: Sequence[Optional[str]]) -> P:
    """Spec of a parameter under the active rules (``P()`` without)."""
    ctx = active_rules()
    if ctx is None:
        return P()
    _, rules = ctx
    return logical_to_spec(names, rules)


# ------------------------------------------------------------- local calls


def _parse(sig: str):
    ins, outs = sig.split("->")
    return ins.split(","), outs.split(",")


def _choose(labels, args, mesh, keep, outs, split):
    """The label each mesh dim keeps sharded (None: replicate): the first
    argument's sharded label that may stay sharded, else the first label
    of ``split`` that every argument having it divides evenly."""
    chosen = []

    def even(name, i):
        degree = mesh.size(i) * math.prod(
            mesh.size(j) for j, c in enumerate(chosen) if c == name)
        return all(x.shape[l.index(name)] % degree == 0
                   for l, x in zip(labels, args)
                   if l and l != "~" and isinstance(x, torch.Tensor)
                   and name in l)

    for i in range(mesh.ndim):
        pick = None
        for lab, a in zip(labels, args):
            if not isinstance(a, DTensor) or not lab or lab == "~":
                continue
            pl = a.placements[i]
            if not isinstance(pl, Shard):
                continue
            name = lab[pl.dim]
            if keep is not None and name not in keep:
                continue
            if keep is not None and any(name not in o for o in outs if o):
                continue
            if even(name, i):
                pick = name
                break
        if pick is None:
            pick = next((n for n in split if even(n, i)), None)
        chosen.append(pick)
    return chosen


def local_call(fn, sig: str, *args, keep: Optional[str] = None,
               split: str = ""):
    """``fn(*args)``, run on local shards where an argument is a DTensor.

    ``sig`` names the dims of each positional argument and of each output
    (outputs flattened in order), einsum style: ``"bsd,dnh->bsnh"``; an
    empty entry marks a non-tensor argument (or output), ``~`` a tree of
    weights that is gathered whole.  Each mesh dim
    keeps the first sharded label it finds (in argument order) that all
    arguments having it can split evenly, and the arguments are
    redistributed to it: sliced where replicated, gathered where sharded
    on another label.  Partial arguments are reduced first.  With ``keep``
    only its labels may stay sharded, and only where every output has
    them (``fn`` is then any function that is independent along them),
    and a mesh dim that keeps none splits the first label of ``split``
    that divides evenly (the attention's heads: redistributed from a
    split head dim, sliced where replicated);
    without, ``fn`` is a product: a label that no output has (a
    contraction) leaves its outputs ``Partial``.  Plain tensor arguments
    are read as replicated.  The gradient of an argument replicated over
    a mesh dim that splits the work is ``Partial`` there (every rank adds
    its part).  With no DTensor argument this is ``fn(*args)``.
    """
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = dts[0].device_mesh
    labels, outs = _parse(sig)
    if len(labels) != len(args):
        raise ValueError(f"local_call: {sig!r} names {len(labels)} "
                         f"arguments, got {len(args)}")
    args = list(args)
    for k, (lab, a) in enumerate(zip(labels, args)):
        if lab == "~":      # a tree of weights, every leaf gathered
            args[k] = pytree.tree_map(
                lambda t: t.redistribute(mesh, [Replicate()] * mesh.ndim)
                if isinstance(t, DTensor) else t, a)
            continue
        if not lab or not isinstance(a, torch.Tensor):
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if any(isinstance(p, Partial) for p in a.placements):
            a = a.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                      else p for p in a.placements])
        args[k] = a
    chosen = _choose(labels, args, mesh, keep, outs, split)
    # an argument replicated over a mesh dim that splits the work gets a
    # gradient from every rank there: Partial
    grad_of_replicated = tuple(Replicate() if c is None else Partial()
                               for c in chosen)
    in_pl, grad_pl = [], []
    for lab, a in zip(labels, args):
        if lab == "~":
            leaves = [isinstance(t, DTensor) for t in pytree.tree_leaves(a)]
            in_pl += [(Replicate(),) * mesh.ndim if d else None
                      for d in leaves]
            grad_pl += [grad_of_replicated if d else None for d in leaves]
        elif isinstance(a, DTensor):
            in_pl.append(tuple(Shard(lab.index(c)) if c and c in lab
                               else Replicate() for c in chosen))
            grad_pl.append(tuple(
                p if isinstance(p, Shard) else g
                for p, g in zip(in_pl[-1], grad_of_replicated)))
        else:
            in_pl.append(None)
            grad_pl.append(None)
    out_pl = []
    for o in outs:
        if not o:
            out_pl.append(None)
            continue
        out_pl.append(tuple(
            Replicate() if c is None else
            Shard(o.index(c)) if c in o else Partial() for c in chosen))
    run = local_map(fn, out_placements=tuple(out_pl),
                    in_placements=tuple(in_pl),
                    in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(*args)


def local_offset(x, dim: int) -> int:
    """This rank's offset along ``dim`` of DTensor ``x``'s local shard."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return int(offset[dim])


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))
