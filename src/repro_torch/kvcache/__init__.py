"""Paged KV-cache block accounting."""

from repro_torch.kvcache.allocator import BlockAllocator, OutOfBlocks, SeqAlloc
from repro_torch.kvcache.prefix import PrefixAwareAllocator, PrefixNode

__all__ = [
    "BlockAllocator",
    "OutOfBlocks",
    "PrefixAwareAllocator",
    "PrefixNode",
    "SeqAlloc",
]
