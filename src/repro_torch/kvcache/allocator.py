"""Paged KV-cache block allocator (vLLM-style bookkeeping, TPU-adapted).

Tracks a fixed pool of KV blocks (block_size tokens each, in the paper's
model-independent per-token units — footnote 1).  Sequences own block
tables; admission, growth, swap-out and swap-in are all expressed in whole
blocks.  The allocator is pure bookkeeping: the tensor cache lives in the
engine; on TPU the block table is what the Pallas paged-attention kernel
walks (kernels/paged_attention.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class OutOfBlocks(Exception):
    pass


@dataclasses.dataclass
class SeqAlloc:
    seq_id: int
    block_table: list[int]
    n_tokens: int = 0
    swapped: bool = False

    @property
    def n_blocks(self) -> int:
        return len(self.block_table)


class BlockAllocator:
    def __init__(self, total_tokens: int, block_size: int = 16):
        if total_tokens <= 0 or block_size <= 0:
            raise ValueError("positive sizes required")
        self.block_size = block_size
        self.n_blocks = total_tokens // block_size
        self._free: list[int] = list(range(self.n_blocks))
        self._seqs: dict[int, SeqAlloc] = {}
        self.swap_events = 0
        # incremental occupancy counter: sum of n_tokens over LIVE (non-
        # swapped) sequences, maintained by every mutator so used_tokens is
        # O(1) — the engine reads it per admission pass and per decode
        # window; check_invariants re-derives and asserts it
        self._used_tokens = 0

    # ------------------------------------------------------------- queries

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def free_tokens(self) -> int:
        return self.free_blocks * self.block_size

    @property
    def used_tokens(self) -> int:
        return self._used_tokens

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_admit(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.free_blocks

    def seq(self, seq_id: int) -> SeqAlloc:
        return self._seqs[seq_id]

    def live_seqs(self) -> list[int]:
        return [k for k, s in self._seqs.items() if not s.swapped]

    # ------------------------------------------------------------ mutation

    def admit(self, seq_id: int, n_tokens: int) -> SeqAlloc:
        need = self.blocks_for(max(1, n_tokens))
        if need > self.free_blocks:
            raise OutOfBlocks(f"need {need} blocks, have {self.free_blocks}")
        blocks = [self._free.pop() for _ in range(need)]
        alloc = SeqAlloc(seq_id=seq_id, block_table=blocks, n_tokens=n_tokens)
        self._seqs[seq_id] = alloc
        self._used_tokens += n_tokens
        return alloc

    def append_token(self, seq_id: int) -> bool:
        """Grow a sequence by one token; returns False if a new block was
        needed but the pool is exhausted (caller must swap someone out)."""
        s = self._seqs[seq_id]
        if s.swapped:
            raise ValueError(f"seq {seq_id} is swapped out")
        if s.n_tokens + 1 > s.n_blocks * self.block_size:
            if not self._free:
                return False
            s.block_table.append(self._free.pop())
        s.n_tokens += 1
        self._used_tokens += 1
        return True

    def append_tokens(self, seq_id: int, k: int) -> bool:
        """Grow a sequence by ``k`` tokens at once (all-or-nothing).

        Equivalent to ``k`` successful ``append_token`` calls but O(new
        blocks) instead of O(k): the engine's multi-iteration decode
        windows pre-size ``k`` so every append is known to fit, then
        commit the growth in one call.  Returns False (and allocates
        nothing) if the pool cannot host all ``k`` tokens.
        """
        if k <= 0:
            return True
        s = self._seqs[seq_id]
        if s.swapped:
            raise ValueError(f"seq {seq_id} is swapped out")
        need = self.blocks_for(s.n_tokens + k) - s.n_blocks
        if need > len(self._free):
            return False
        for _ in range(need):
            s.block_table.append(self._free.pop())
        s.n_tokens += k
        self._used_tokens += k
        return True

    def swap_out(self, seq_id: int) -> int:
        """Release a live sequence's blocks (KV content moves to host in the
        engine).  Returns the number of freed blocks."""
        s = self._seqs[seq_id]
        if s.swapped:
            return 0
        freed = len(s.block_table)
        self._free.extend(s.block_table)
        s.block_table = []
        s.swapped = True
        self.swap_events += 1
        self._used_tokens -= s.n_tokens
        return freed

    def swap_in(self, seq_id: int) -> bool:
        """Re-allocate blocks for a swapped sequence; False if no room."""
        s = self._seqs[seq_id]
        if not s.swapped:
            return True
        need = self.blocks_for(max(1, s.n_tokens))
        if need > self.free_blocks:
            return False
        s.block_table = [self._free.pop() for _ in range(need)]
        s.swapped = False
        self._used_tokens += s.n_tokens
        return True

    def release(self, seq_id: int) -> None:
        s = self._seqs.pop(seq_id)
        self._free.extend(s.block_table)
        if not s.swapped:
            self._used_tokens -= s.n_tokens

    def check_invariants(self) -> None:
        owned = [b for s in self._seqs.values() for b in s.block_table]
        all_blocks = owned + self._free
        assert len(all_blocks) == len(set(all_blocks)), "double allocation"
        assert len(all_blocks) == self.n_blocks, "block leak"
        for s in self._seqs.values():
            if not s.swapped:
                assert s.n_blocks * self.block_size >= s.n_tokens
        live = sum(s.n_tokens for s in self._seqs.values() if not s.swapped)
        assert self._used_tokens == live, (
            f"used_tokens counter drifted: {self._used_tokens} != {live}"
        )
