"""Prefix-aware KV block reuse: a content-hash radix index over
:class:`BlockAllocator` blocks (PR 6).

Design (vLLM-style automatic prefix caching, adapted to the paper's
model-independent token units):

* **Hashing granularity** — only FULL blocks (``block_size`` tokens) are
  content-addressed.  A block's identity is the chain key
  ``(parent_node_id, tokens_in_block)``: two prompts share a block only
  when every earlier block also matched, so the index is a radix trie
  keyed by block-sized token runs.  The final partial block of a prompt
  is always private — partial-block sharing is what forces eager COW in
  other designs, so we exclude it by construction.
* **Refcounts / pinning** — a cached node's refcount is the number of
  live sequences whose block table references it.  Referenced blocks are
  pinned: they can never be evicted or handed out.  Because every
  reference is a root-contiguous chain, ``refcount(parent) >=
  refcount(child)`` always holds.
* **LRU free-list** — when a node's refcount drops to zero its block is
  NOT returned to the free list; the node parks in an LRU ordered dict
  and stays matchable.  Allocation prefers truly-free blocks and only
  then evicts LRU nodes, oldest first, leaves first (a node with cached
  children is skipped so a chain never loses an interior block).
  ``free_blocks`` therefore counts ``free + unreferenced-cached``.
* **Copy-on-write** — engine paths never write into a cached block
  (appends land in the private partial block or a fresh block), but
  :meth:`fork` can branch a sequence mid-block, leaving its write cursor
  inside a shared block.  The first append then unshares every chain
  block at or past the cursor: dereference the node, allocate a private
  replacement (a refcount-0 node may be reclaimed in place), and count a
  ``cow_copies``.  Appends stay all-or-nothing: availability is checked
  before any state changes, counting one fresh block per COW target
  whose node is still shared (``refcount > 1``).

The allocator stays pure bookkeeping — the engine's tensor cache is
slot-indexed, so block sharing models the *accounting and timing* of
prefix reuse (blocks held, prefill iterations charged) while tensor
prefill still computes full prompts bit-identically.
"""

from __future__ import annotations

import dataclasses
from collections import Counter, OrderedDict
from typing import Optional, Sequence

from repro_torch.kvcache.allocator import BlockAllocator, OutOfBlocks, SeqAlloc

TokenRun = tuple[int, ...]
_ROOT = -1


@dataclasses.dataclass
class PrefixNode:
    """One cached full block in the radix index."""

    node_id: int
    block: int
    key: tuple  # (parent node_id, block token tuple)
    parent: int  # parent node_id, _ROOT at depth 0
    refcount: int = 0
    n_children: int = 0  # cached (not evicted) children


class PrefixAwareAllocator(BlockAllocator):
    """Block allocator with a content-hash prefix index and COW refcounts."""

    def __init__(self, total_tokens: int, block_size: int = 16):
        super().__init__(total_tokens, block_size)
        self._nodes: dict[int, PrefixNode] = {}
        self._index: dict[tuple, PrefixNode] = {}
        # refcount-0 nodes, oldest first (insertion order = eviction order)
        self._lru: "OrderedDict[int, PrefixNode]" = OrderedDict()
        # per-seq root-contiguous referenced node ids (block_table prefix)
        self._chains: dict[int, list[int]] = {}
        # per-seq full-block token runs, for swap-in re-matching; kept in
        # lockstep with the chain under COW truncation
        self._chain_tokens: dict[int, list[TokenRun]] = {}
        self._next_node = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.cow_copies = 0

    # ------------------------------------------------------------- queries

    @property
    def free_blocks(self) -> int:
        # unreferenced cached blocks are evictable on demand
        return len(self._free) + len(self._lru)

    @property
    def cached_blocks(self) -> int:
        return len(self._nodes)

    def _full_runs(self, tokens: Sequence[int]) -> list[TokenRun]:
        bs = self.block_size
        return [
            tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            for i in range(len(tokens) // bs)
        ]

    def _walk(self, runs: Sequence[TokenRun]) -> list[PrefixNode]:
        """Longest cached chain matching ``runs`` (lookup only)."""
        out: list[PrefixNode] = []
        parent = _ROOT
        for run in runs:
            node = self._index.get((parent, run))
            if node is None:
                break
            out.append(node)
            parent = node.node_id
        return out

    def match_tokens(self, tokens: Sequence[int]) -> int:
        """Cached-prefix length (tokens) for a prompt, without admitting."""
        return len(self._walk(self._full_runs(tokens))) * self.block_size

    def can_admit_prefix(self, tokens: Sequence[int],
                         n_tokens: Optional[int] = None) -> bool:
        """Admission check for :meth:`admit_prefix`.

        ``n_tokens`` defaults to ``len(tokens) + 1`` — the engine's
        ``can_admit(len(prompt) + 1)`` convention (room for the first
        decode token).  Matched blocks cost nothing, but matched
        refcount-0 blocks leave the evictable pool once re-referenced.
        """
        n = len(tokens) + 1 if n_tokens is None else n_tokens
        matched = self._walk(self._full_runs(tokens))
        in_lru = sum(1 for nd in matched if nd.refcount == 0)
        need = self.blocks_for(max(1, n)) - len(matched)
        return need <= len(self._free) + len(self._lru) - in_lru

    def swap_in_need(self, seq_id: int) -> int:
        """Fresh blocks a swapped sequence would need to come back now."""
        s = self._seqs[seq_id]
        if not s.swapped:
            return 0
        matched = self._walk(self._chain_tokens.get(seq_id, []))
        return max(0, self.blocks_for(max(1, s.n_tokens)) - len(matched))

    def can_swap_in(self, seq_id: int) -> bool:
        """Would :meth:`swap_in` succeed right now (lookup only)?"""
        s = self._seqs[seq_id]
        if not s.swapped:
            return True
        matched = self._walk(self._chain_tokens.get(seq_id, []))
        in_lru = sum(1 for nd in matched if nd.refcount == 0)
        need = self.blocks_for(max(1, s.n_tokens)) - len(matched)
        return need <= len(self._free) + len(self._lru) - in_lru

    # ------------------------------------------------------- node plumbing

    def _ref(self, node: PrefixNode) -> None:
        node.refcount += 1
        if node.refcount == 1:
            self._lru.pop(node.node_id, None)

    def _deref(self, node: PrefixNode) -> None:
        node.refcount -= 1
        assert node.refcount >= 0, "negative refcount"
        if node.refcount == 0:
            self._lru[node.node_id] = node  # newest end

    def _register(self, parent: int, run: TokenRun, block: int) -> PrefixNode:
        node = PrefixNode(
            node_id=self._next_node, block=block, key=(parent, run),
            parent=parent, refcount=1,
        )
        self._next_node += 1
        self._nodes[node.node_id] = node
        self._index[node.key] = node
        if parent != _ROOT:
            self._nodes[parent].n_children += 1
        return node

    def _evict(self, node: PrefixNode) -> int:
        del self._lru[node.node_id]
        del self._index[node.key]
        del self._nodes[node.node_id]
        if node.parent != _ROOT:
            self._nodes[node.parent].n_children -= 1
        self.evictions += 1
        return node.block

    def _pop_block(self) -> int:
        if self._free:
            return self._free.pop()
        # oldest evictable leaf; any LRU node's cached children are also
        # refcount-0 (chains reference root-contiguously), so scanning
        # always finds a leaf while the LRU is non-empty
        for node in self._lru.values():
            if node.n_children == 0:
                return self._evict(node)
        raise OutOfBlocks("no free or evictable blocks")

    # ------------------------------------------------------------ mutation

    def admit(self, seq_id: int, n_tokens: int) -> SeqAlloc:
        """Content-free admission (no prompt ids): nothing is cached, but
        allocation may still evict unreferenced cached blocks."""
        need = self.blocks_for(max(1, n_tokens))
        if need > len(self._free) + len(self._lru):
            raise OutOfBlocks(f"need {need} blocks, have {self.free_blocks}")
        blocks = [self._pop_block() for _ in range(need)]
        alloc = SeqAlloc(seq_id=seq_id, block_table=blocks, n_tokens=n_tokens)
        self._seqs[seq_id] = alloc
        self._used_tokens += n_tokens
        self._chains[seq_id] = []
        self._chain_tokens[seq_id] = []
        return alloc

    def admit_prefix(self, seq_id: int,
                     tokens: Sequence[int]) -> tuple[SeqAlloc, int]:
        """Admit a prompt, sharing its longest cached full-block prefix.

        Returns ``(alloc, hit_tokens)``.  Every fresh FULL block is
        registered in the index (refcount 1) so later prompts can share
        it; the partial tail block stays private.  ``n_tokens`` counts
        the full logical prompt — ``used_tokens`` stays a logical
        occupancy measure, sharing only dedups physical blocks.
        """
        n = len(tokens)
        runs = self._full_runs(tokens)
        matched = self._walk(runs)
        for node in matched:
            self._ref(node)
        chain = [nd.node_id for nd in matched]
        need = self.blocks_for(max(1, n)) - len(chain)
        if need > len(self._free) + len(self._lru):
            for nid in reversed(chain):
                self._deref(self._nodes[nid])
            raise OutOfBlocks(f"need {need} blocks, have {self.free_blocks}")
        table = [self._nodes[nid].block for nid in chain]
        parent = chain[-1] if chain else _ROOT
        for i in range(need):
            block = self._pop_block()
            j = len(chain)
            if j < len(runs):  # fresh full prompt block: cacheable
                node = self._register(parent, runs[j], block)
                chain.append(node.node_id)
                parent = node.node_id
            table.append(block)
        alloc = SeqAlloc(seq_id=seq_id, block_table=table, n_tokens=n)
        self._seqs[seq_id] = alloc
        self._used_tokens += n
        self._chains[seq_id] = chain
        self._chain_tokens[seq_id] = runs
        hit = len(matched) * self.block_size
        self.hit_tokens += hit
        return alloc, hit

    def fork(self, seq_id: int, new_seq_id: int,
             n_tokens: Optional[int] = None) -> SeqAlloc:
        """Copy-on-write branch of a live sequence at ``n_tokens``.

        The branch re-references every cached chain block covering its
        kept prefix — including a final *partially kept* block when
        ``n_tokens`` lands mid-block, which the next append unshares (the
        COW path).  Tokens past the chain get fresh private blocks.
        """
        src = self._seqs[seq_id]
        if src.swapped:
            raise ValueError(f"seq {seq_id} is swapped out")
        if new_seq_id in self._seqs:
            raise ValueError(f"seq {new_seq_id} already exists")
        n = src.n_tokens if n_tokens is None else n_tokens
        if not 0 < n <= src.n_tokens:
            raise ValueError(f"fork point {n} outside (0, {src.n_tokens}]")
        src_chain = self._chains.get(seq_id, [])
        total = self.blocks_for(max(1, n))
        keep = min(len(src_chain), total)
        need = total - keep
        if need > len(self._free) + len(self._lru):
            raise OutOfBlocks(f"need {need} blocks, have {self.free_blocks}")
        chain = []
        for nid in src_chain[:keep]:
            self._ref(self._nodes[nid])
            chain.append(nid)
        table = [self._nodes[nid].block for nid in chain]
        table.extend(self._pop_block() for _ in range(need))
        alloc = SeqAlloc(seq_id=new_seq_id, block_table=table, n_tokens=n)
        self._seqs[new_seq_id] = alloc
        self._used_tokens += n
        self._chains[new_seq_id] = chain
        self._chain_tokens[new_seq_id] = self._chain_tokens.get(
            seq_id, [])[:keep]
        return alloc

    def _cow_targets(self, s: SeqAlloc) -> list[int]:
        """Chain node ids the next append would write into (normally
        empty: chains cover full blocks and the write cursor sits past
        them — only a mid-block fork leaves it inside a shared block)."""
        chain = self._chains.get(s.seq_id)
        if not chain:
            return []
        tgt = s.n_tokens // self.block_size
        return chain[tgt:] if tgt < len(chain) else []

    def _cow_unshare(self, s: SeqAlloc, targets: list[int]) -> None:
        tgt = len(self._chains[s.seq_id]) - len(targets)
        for nid in reversed(targets):
            self._deref(self._nodes[nid])
        for i in range(tgt, tgt + len(targets)):
            s.block_table[i] = self._pop_block()
        del self._chains[s.seq_id][tgt:]
        runs = self._chain_tokens.get(s.seq_id)
        if runs is not None:
            del runs[tgt:]
        self.cow_copies += len(targets)

    def append_token(self, seq_id: int) -> bool:
        s = self._seqs[seq_id]
        if s.swapped:
            raise ValueError(f"seq {seq_id} is swapped out")
        need = 1 if s.n_tokens + 1 > s.n_blocks * self.block_size else 0
        targets = self._cow_targets(s)
        # a still-shared COW target needs a genuinely fresh block; a
        # refcount-1 target's own block becomes reclaimable on deref
        fresh = need + sum(
            1 for nid in targets if self._nodes[nid].refcount > 1)
        if fresh > len(self._free) + len(self._lru):
            return False
        if targets:
            self._cow_unshare(s, targets)
        if need:
            s.block_table.append(self._pop_block())
        s.n_tokens += 1
        self._used_tokens += 1
        return True

    def append_tokens(self, seq_id: int, k: int) -> bool:
        if k <= 0:
            return True
        s = self._seqs[seq_id]
        if s.swapped:
            raise ValueError(f"seq {seq_id} is swapped out")
        need = self.blocks_for(s.n_tokens + k) - s.n_blocks
        targets = self._cow_targets(s)
        fresh = max(0, need) + sum(
            1 for nid in targets if self._nodes[nid].refcount > 1)
        if fresh > len(self._free) + len(self._lru):
            return False
        if targets:
            self._cow_unshare(s, targets)
        for _ in range(max(0, need)):
            s.block_table.append(self._pop_block())
        s.n_tokens += k
        self._used_tokens += k
        return True

    def swap_out(self, seq_id: int) -> int:
        s = self._seqs[seq_id]
        if s.swapped:
            return 0
        chain = self._chains.get(seq_id, [])
        freed = len(s.block_table)
        self._free.extend(s.block_table[len(chain):])
        for nid in reversed(chain):
            self._deref(self._nodes[nid])
        self._chains[seq_id] = []
        s.block_table = []
        s.swapped = True
        self.swap_events += 1
        self._used_tokens -= s.n_tokens
        return freed

    def swap_in(self, seq_id: int) -> bool:
        s = self._seqs[seq_id]
        if not s.swapped:
            return True
        runs = self._chain_tokens.get(seq_id, [])
        matched = self._walk(runs)
        for node in matched:
            self._ref(node)
        chain = [nd.node_id for nd in matched]
        need = self.blocks_for(max(1, s.n_tokens)) - len(chain)
        if need > len(self._free) + len(self._lru):
            for nid in reversed(chain):
                self._deref(self._nodes[nid])
            return False
        table = [self._nodes[nid].block for nid in chain]
        parent = chain[-1] if chain else _ROOT
        for _ in range(need):
            block = self._pop_block()
            j = len(chain)
            if j < len(runs):  # re-register the restored prompt block
                node = self._register(parent, runs[j], block)
                chain.append(node.node_id)
                parent = node.node_id
            table.append(block)
        s.block_table = table
        s.swapped = False
        self._chains[seq_id] = chain
        self._used_tokens += s.n_tokens
        return True

    def release(self, seq_id: int) -> None:
        s = self._seqs.pop(seq_id)
        chain = self._chains.pop(seq_id, [])
        self._chain_tokens.pop(seq_id, None)
        if not s.swapped:
            self._free.extend(s.block_table[len(chain):])
            # deepest first so later eviction drains chains leaf-first
            for nid in reversed(chain):
                self._deref(self._nodes[nid])
            self._used_tokens -= s.n_tokens

    # ---------------------------------------------------------- invariants

    def check_invariants(self) -> None:
        cached = [nd.block for nd in self._nodes.values()]
        private: list[int] = []
        refs: Counter = Counter()
        for sid, s in self._seqs.items():
            chain = self._chains.get(sid, [])
            if s.swapped:
                assert not s.block_table, "swapped seq holds blocks"
                assert not chain, "swapped seq holds references"
                continue
            assert s.n_blocks * self.block_size >= s.n_tokens
            assert len(chain) <= len(s.block_table), "chain exceeds table"
            for i, nid in enumerate(chain):
                node = self._nodes[nid]
                assert s.block_table[i] == node.block, "chain/table mismatch"
                refs[nid] += 1
            private.extend(s.block_table[len(chain):])
        all_blocks = cached + private + self._free
        assert len(all_blocks) == len(set(all_blocks)), "double allocation"
        assert len(all_blocks) == self.n_blocks, "block leak"
        kids: Counter = Counter(
            nd.parent for nd in self._nodes.values() if nd.parent != _ROOT)
        assert len(self._index) == len(self._nodes), "index drift"
        for nid, node in self._nodes.items():
            assert node.refcount == refs.get(nid, 0), (
                f"refcount drift on node {nid}: "
                f"{node.refcount} != {refs.get(nid, 0)}"
            )
            assert (node.refcount == 0) == (nid in self._lru), (
                "LRU holds a referenced node" if node.refcount
                else "unreferenced node missing from LRU"
            )
            assert self._index.get(node.key) is node, "index drift"
            assert node.n_children == kids.get(nid, 0), "child count drift"
            if node.parent != _ROOT:
                parent = self._nodes.get(node.parent)
                assert parent is not None, "child outlived evicted parent"
                assert parent.refcount >= node.refcount, (
                    "chain reference not root-contiguous"
                )
        live = sum(s.n_tokens for s in self._seqs.values() if not s.swapped)
        assert self._used_tokens == live, (
            f"used_tokens counter drifted: {self._used_tokens} != {live}"
        )
