"""Per-device op accounting of a plan run eagerly: the port's counterpart
of ``repro.launch.hlo_analysis``.

The JAX package parses the SPMD-partitioned HLO text of a compiled plan
and multiplies each while-loop body by its trip count.  The port has no
HLO: it runs the plan eagerly (on ``meta`` tensors in the dry-run) under
``OpCounter``, a ``TorchDispatchMode`` that sees every op on the LOCAL
shards.  For an op on DTensors the mode steps aside (it returns
``NotImplemented``), so DTensor's dispatch runs first and the mode sees
what it issues beneath: the op on this rank's shards and the collectives
of every redistribution (the fake-tensor runs of its sharding
propagation, at the global shapes, are not counted).  ``FlopCounterMode``
wrapped around DTensor code would count the logical op instead.  Python loops run
every iteration, so a loop of 10 matmuls counts 10 times one and nested
loops multiply, where the HLO analysis scales loop bodies.

Per device it counts:

  * flops            — 2 * M * N * K for each matmul / bmm / baddbmm /
                       einsum (through the products it lowers to) and the
                       convolutions, from ``torch.utils.flop_counter``'s
                       formulas, as ``_dot_flops`` counts dots;
  * bytes            — bytes of every tensor read and written at op
                       boundaries (views and metadata ops excluded).  Eager
                       execution has no fusion, so this is an upper bound
                       on the HLO analysis's fusion-boundary count;
  * collective bytes — output bytes and counts of each collective kind
                       (all-gather, all-reduce, reduce-scatter, all-to-all,
                       and collective-permute where DTensor issues one).

Loops of identical iterations (the chunked attention's q and k chunks,
the recurrences' tokens and chunks) ask ``loop_weights`` how many to run:
all of them, except on ``meta`` tensors under a counter, where three run
and the middle one counts n - 2 times (``repeated``), as ``hlo_analysis``
scales a scan body by its trip count (a meta run computes shapes, not
values).

The HLO-file dump of the JAX dry-run has no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_FAKE = torch._C._TorchDispatchModeKey.FAKE

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: substrings of op names -> collective kind, in match order
_COLLECTIVE_NAMES = (
    ("reduce_scatter", "reduce-scatter"),
    ("all_gather", "all-gather"),
    ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
    ("permute", "collective-permute"),
    ("send", "collective-permute"),
    ("broadcast", "collective-permute"),
)

#: ops that move no data (aliases, metadata, waits)
_FREE = {
    "detach", "alias", "lift_fresh", "wait_tensor", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim",
    "is_same_size", "_to_copy_meta",
}


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: {c: 0 for c in COLLECTIVES})
    coll_bytes_by: dict = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    n_ops: int = 0

    def add(self, other: "OpStats", scale: float = 1.0) -> None:
        self.flops += other.flops * scale
        self.bytes += other.bytes * scale
        self.coll_bytes += other.coll_bytes * scale
        self.n_ops += int(other.n_ops * scale)
        for c in COLLECTIVES:
            self.coll_counts[c] += other.coll_counts[c] * scale
            self.coll_bytes_by[c] += other.coll_bytes_by[c] * scale

    def scaled_sum(self, terms: list) -> "OpStats":
        """``self`` plus each ``(stats, scale)`` of ``terms`` (a new
        object)."""
        out = OpStats()
        out.add(self)
        for st, k in terms:
            out.add(st, k)
        return out

    def collectives(self) -> dict:
        """The JAX dry-run's record layout: per kind ``count`` and
        ``bytes``, plus ``total_bytes`` and ``total_count``."""
        out = {c: {"count": self.coll_counts[c],
                   "bytes": self.coll_bytes_by[c]} for c in COLLECTIVES}
        out["total_bytes"] = self.coll_bytes
        out["total_count"] = sum(self.coll_counts.values())
        return out


_active = threading.local()


def _counters() -> list:
    if not hasattr(_active, "stack"):
        _active.stack = []
    return _active.stack


def loop_weights(n: int, x) -> list[int]:
    """How often each run iteration of a loop of ``n`` identical ones over
    ``x`` counts: ``[1] * n`` (every iteration runs), or ``[1, n - 2, 1]``
    when ``x`` is a ``meta`` tensor (a DTensor's local shard counts) and
    an ``OpCounter`` is counting.  Three iterations run then: the first
    (whose carried inputs come from outside the loop, maybe without
    grad), one that stands for every middle one, and the last (whose
    carried outputs may go unused), so that the backward of each kind is
    counted."""
    if isinstance(x, DTensor):
        x = x._local_tensor
    if n > 3 and _counters() and x.device.type == "meta":
        return [1, n - 2, 1]
    return [1] * n


def expand(outs: list, weights: list[int]) -> list:
    """Each iteration's output repeated by its weight (an n-long list)."""
    return [o for o, w in zip(outs, weights) for _ in range(w)]


def _next_node_nr() -> int:
    """The sequence number autograd gives its next node (a marker node is
    made for it)."""
    marker = torch.empty((), device="meta", requires_grad=True) * 1
    return marker.grad_fn._sequence_nr() + 1


@contextlib.contextmanager
def repeated(k: int):
    """Counts of the ops run inside are multiplied by ``k`` (nests), and so
    are those of the backward of the autograd nodes made inside: each
    counter keeps the range of their sequence numbers, and counts a
    backward op ``k`` times where the node running it lies in the range."""
    stack = _counters()
    if k == 1 or not stack:
        yield
        return
    grad = torch.is_grad_enabled()
    first = _next_node_nr() if grad else 0
    for c in stack:
        c.scale *= k
    try:
        yield
    finally:
        for c in stack:
            c.scale /= k
        if grad:
            last = _next_node_nr()
            for c in stack:
                c.node_ranges.append((first, last, k))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _collective_kind(name: str):
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return None


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it, per device (see the module doc); the
    totals are in ``self.stats``."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self.scale = 1
        self.node_ranges: list[tuple[int, int, int]] = []

    def _backward_scale(self) -> int:
        """The repeat count of the autograd node whose backward runs now
        (1 outside backward: a checkpoint's recompute runs with grad on
        and is scaled by ``self.scale``)."""
        if torch.is_grad_enabled() or not self.node_ranges:
            return 1
        node = torch._C._current_autograd_node()
        if node is None:
            return 1
        nr, k = node._sequence_nr(), 1
        for first, last, reps in self.node_ranges:
            if first <= nr < last:
                k *= reps
        return k

    def __enter__(self):
        _counters().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _counters().remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs the op on fake tensors of the
        # global shapes to learn the output's; that is not work of a device
        if torch._C._get_dispatch_mode(_FAKE) is None:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        st, k = self.stats, self.scale * self._backward_scale()
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                  "_dtensor"):
            kind = _collective_kind(name)
            if kind is None:
                return
            nbytes = k * sum(_nbytes(t) for t in tree_leaves(out))
            st.coll_counts[kind] += k
            st.coll_bytes_by[kind] += nbytes
            st.coll_bytes += nbytes
            st.bytes += nbytes
            return
        st.n_ops += k
        if packet in flop_registry:
            st.flops += k * flop_registry[packet](*args, **kwargs,
                                                  out_val=out)
        if name in _FREE or func.is_view:
            return
        st.bytes += k * sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
        st.bytes += k * sum(_nbytes(t) for t in tree_leaves(out))


def count_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpStats)`` of one eager run."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
