"""``OrderedQueue`` — the shared priority queue of the sim and the engine.

Both backends keep two request queues (waiting, swapped) ordered by the
scheduler's priority key, and both used to pay for that ordering on every
admission pass: a full ``sort(key=...)`` re-invoking the policy once per
element, per pass.  This class factors the PR-1 static-key fast path of the
engine into a backend-neutral structure and extends it to dynamic policies:

* **static policies** (``scheduler.dynamic == False`` — Justitia, FCFS,
  SJF, Parrot): a request's key never changes after submission, so it is
  evaluated exactly once at ``push`` and the queue stays sorted by
  construction (``bisect.insort``); no admission pass ever re-sorts.
* **dynamic policies** (VTC, SRJF), plain mode: keys move with the
  scheduler's service counters, so the queue re-sorts lazily at
  ``refresh`` — but only when it can actually be stale: a new item was
  pushed, or the scheduler's ``version`` mutation counter moved since the
  last sort.  Two admission passes with no intervening service deal or
  arrival share one sort.
* **dynamic policies, grouped mode** (``group_fn`` given): for policies
  whose key depends only on the request and its *agent's* record
  (``scheduler.agent_keyed`` — both built-in dynamic policies qualify),
  the queue stays sorted like the static path and ``refresh`` repositions
  only items whose group was invalidated via ``mark_dirty`` since the
  last pass.  A backlogged queue of W requests with k freshly-serviced
  agents re-sorts in O(k log W) key space instead of O(W log W): queued
  agents with no running inference have frozen counters and never move.

Invariant required of dynamic keys (and satisfied by every built-in
policy): ``request_key(req, t)`` must be a function of the *scheduler's
state* (captured by ``AgentScheduler.version``) and the request alone —
never of the clock ``t`` directly.  A policy whose key decays with wall
time would need ``refresh(version=None)`` (sort every pass) instead.
Grouped mode additionally requires the backend to ``mark_dirty(group)``
for every agent whose record it mutates (each ``on_service`` deal and each
arrival); ``push`` self-marks its own group.

``sorts`` and ``key_evals`` are exposed so backends can surface scheduling
overhead (``metrics["sorts"]``, ``SimResult.key_evals``) without wrapping
the policy object.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, Iterator, Optional

__all__ = ["OrderedQueue"]


class OrderedQueue:
    """Priority queue with cached keys and lazy re-sorting (see module doc).

    ``key_fn`` maps an item to its (totally ordered — include a tie-break
    like ``rid``) sort key; it is the only place the scheduler policy is
    invoked.  Lower key = served first; ``peek``/``popleft`` address the
    head.  ``refresh`` must be called before reading the head under a
    dynamic policy (it is a no-op for static ones).
    """

    def __init__(
        self,
        key_fn: Callable[[Any], Any],
        *,
        dynamic: bool = False,
        group_fn: Optional[Callable[[Any], Any]] = None,
    ):
        self.key_fn = key_fn
        self.dynamic = bool(dynamic)
        self.group_fn = group_fn if dynamic else None
        # _items[_head:] is the live queue; popleft advances _head (O(1))
        # and the dead prefix is compacted away once it dominates —
        # a plain list.pop(0) would memmove the whole backlog per admission
        self._items: list[Any] = []
        self._keys: list[Any] = []        # parallel to _items (sorted modes)
        self._head = 0
        self._dirty = False               # plain dynamic: pushed since sort
        self._dirty_groups: set[Any] = set()
        self._group_items: dict[Any, list[Any]] = {}
        self._item_key: dict[int, Any] = {}   # id(item) -> cached key
        self._last_version: Optional[int] = None
        self.sorts = 0                    # executed re-sorts/repositionings
        self.key_evals = 0                # policy key invocations

    # ------------------------------------------------------------- basics

    @property
    def grouped(self) -> bool:
        return self.group_fn is not None

    def __len__(self) -> int:
        return len(self._items) - self._head

    def __bool__(self) -> bool:
        return len(self._items) > self._head

    def __iter__(self) -> Iterator[Any]:
        return iter(self._items[self._head:])

    # ------------------------------------------------------------ updates

    def _compact(self) -> None:
        if self._head:
            del self._items[: self._head]
            if self._keys:
                del self._keys[: self._head]
            self._head = 0

    def _insort(self, item: Any, key: Any) -> None:
        i = bisect.bisect_right(self._keys, key, self._head)
        self._keys.insert(i, key)
        self._items.insert(i, item)

    def push(self, item: Any) -> None:
        if self.dynamic and not self.grouped:
            self._items.append(item)
            self._dirty = True
            return
        key = self.key_fn(item)
        self.key_evals += 1
        self._insort(item, key)
        # sorted modes cache every item's key: refresh uses it to extract
        # stale grouped items, remove() uses it to locate an arbitrary item
        # in O(log n) instead of a linear scan
        self._item_key[id(item)] = key
        if self.grouped:
            g = self.group_fn(item)
            self._group_items.setdefault(g, []).append(item)
            # the key was sampled at push time; revalidate at next refresh
            # in case the group's counters move before the next decision
            self._dirty_groups.add(g)

    def mark_dirty(self, group: Any) -> None:
        """Grouped mode: ``group``'s keys may have moved (no-op otherwise)."""
        if self.grouped and group in self._group_items:
            self._dirty_groups.add(group)

    def mark_dirty_many(self, groups: set) -> None:
        """Bulk ``mark_dirty`` (set intersection, C-speed)."""
        if self.grouped:
            self._dirty_groups.update(groups & self._group_items.keys())

    def refresh(self, version: Optional[int] = None) -> None:
        """Bring the queue into key order for the next admission pass.

        ``version`` is the scheduler's mutation counter (plain dynamic
        mode); passing the same value twice with no pushes in between skips
        the sort — the keys cannot have moved.  Grouped mode ignores it and
        repositions exactly the items whose group was marked dirty.
        """
        if not self.dynamic:
            return
        if self.grouped:
            self._refresh_grouped()
            return
        if (
            not self._dirty
            and version is not None
            and version == self._last_version
        ):
            return
        self._dirty = False
        self._last_version = version
        self._compact()
        n = len(self._items)
        if n <= 1:
            return
        keys = [self.key_fn(it) for it in self._items]
        self.key_evals += n
        order = sorted(range(n), key=keys.__getitem__)   # stable
        self._items = [self._items[i] for i in order]
        self.sorts += 1

    def _refresh_grouped(self) -> None:
        if not self._dirty_groups:
            return
        moved: list[Any] = []
        for g in self._dirty_groups:
            moved.extend(self._group_items.get(g, ()))
        self._dirty_groups.clear()
        if not moved:
            return
        # two-phase: extract every stale item at its cached key, then
        # re-insert at the fresh one (the untouched remainder stays sorted)
        for item in moved:
            old_key = self._item_key[id(item)]
            i = bisect.bisect_left(self._keys, old_key, self._head)
            while self._items[i] is not item:
                i += 1
            del self._keys[i]
            del self._items[i]
        for item in moved:
            key = self.key_fn(item)
            self.key_evals += 1
            self._item_key[id(item)] = key
            self._insort(item, key)
        self.sorts += 1

    def peek(self) -> Any:
        return self._items[self._head]

    def peek_right(self) -> Any:
        """Item with the WORST key (sorted modes: the tail).

        Call ``refresh`` first under a dynamic policy — exactly as for
        ``peek`` — or the tail may be stale.  This is what backends use for
        swap-victim selection: the running set ordered by scheduler key has
        its eviction candidate at the right end.
        """
        if self._head >= len(self._items):
            # guard explicitly: when a popleft'd (tombstoned) prefix has
            # not been compacted yet, _items[-1] would silently return a
            # dead None slot instead of raising
            raise IndexError("peek_right from empty OrderedQueue")
        return self._items[-1]

    def pop_right(self) -> Any:
        """Remove and return the worst-key item (see ``peek_right``)."""
        if self._head >= len(self._items):
            raise IndexError("pop_right from empty OrderedQueue")
        item = self._items.pop()
        if not self.dynamic or self.grouped:
            self._keys.pop()
        self._forget(item)
        return item

    def popleft(self) -> Any:
        head = self._head
        item = self._items[head]
        self._items[head] = None          # drop the reference
        if not self.dynamic or self.grouped:
            self._keys[head] = None
        self._head = head + 1
        if self._head > 32 and self._head * 2 > len(self._items):
            self._compact()
        self._forget(item)
        return item

    def remove(self, item: Any) -> None:
        """Remove ``item`` (identity comparison) from anywhere in the queue.

        Sorted modes locate it through its cached key — O(log n) bisect
        plus a scan over equal-key siblings (built-in policies tie-break on
        ``rid``, so keys are unique and the scan is O(1)).  Plain dynamic
        mode has no key cache and falls back to a linear identity scan.
        Backends use this to retire a running-set entry on completion.
        """
        if self.dynamic and not self.grouped:
            for i in range(self._head, len(self._items)):
                if self._items[i] is item:
                    del self._items[i]
                    return
            raise ValueError("item not in queue")
        key = self._item_key[id(item)]
        i = bisect.bisect_left(self._keys, key, self._head)
        # identity scan over equal-key siblings (cf. popleft: __eq__ on
        # items is not usable — fields like numpy prompts don't compare)
        while self._items[i] is not item:
            i += 1
        del self._keys[i]
        del self._items[i]
        self._forget(item)

    def _forget(self, item: Any) -> None:
        """Drop the key cache / group bookkeeping of a removed item."""
        if not self.dynamic or self.grouped:
            self._item_key.pop(id(item), None)
        if self.grouped:
            g = self.group_fn(item)
            bucket = self._group_items[g]
            # identity-based removal: list.remove would run __eq__ against
            # same-group siblings, whose fields need not be comparable
            # (e.g. numpy prompt arrays on engine requests)
            for i, x in enumerate(bucket):
                if x is item:
                    del bucket[i]
                    break
            if not bucket:
                del self._group_items[g]
                self._dirty_groups.discard(g)

    def head_key(self) -> Any:
        """Cached key of the head (sorted modes only)."""
        if self.dynamic and not self.grouped:
            raise TypeError("plain dynamic OrderedQueue does not cache keys")
        return self._keys[self._head]

    def clear(self) -> None:
        self._items.clear()
        self._keys.clear()
        self._head = 0
        self._dirty = False
        self._dirty_groups.clear()
        self._group_items.clear()
        self._item_key.clear()
