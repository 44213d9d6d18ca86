"""CUDA attention kernels for Hopper (+ their plain PyTorch versions)."""

from repro_torch.kernels.ops import (
    flash_prefill,
    kernel_library,
    paged_gqa_decode,
    reset_launch_counts,
)
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref

__all__ = [
    "flash_prefill",
    "kernel_library",
    "paged_gqa_decode",
    "reset_launch_counts",
    "flash_attention_ref",
    "paged_attention_ref",
]
