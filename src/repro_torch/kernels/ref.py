"""Plain PyTorch versions of the attention kernels.

Same signatures and layouts as the JAX package's ``kernels/ref.py``.  The
wrappers in ``ops.py`` run these for tensors on the CPU, and the on-card
checks hold each CUDA kernel against them.
"""

from __future__ import annotations

import torch


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """q: (B, n_kv, qpk, hd) pre-scaled; pages: (P, bs, n_kv, hd)."""
    b, n_kv, qpk, hd = q.shape
    max_pages = block_tables.shape[1]
    bs = k_pages.shape[1]
    tables = torch.clamp(block_tables.long(), 0, k_pages.shape[0] - 1)
    # gather each sequence's pages: (B, max_pages, bs, n_kv, hd)
    k = k_pages[tables].reshape(b, max_pages * bs, n_kv, hd)
    v = v_pages[tables].reshape(b, max_pages * bs, n_kv, hd)
    s = torch.einsum("bngh,btnh->bngt", q.float(), k.float())
    ids = torch.arange(max_pages * bs, device=q.device)[None]
    mask = ids < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s,
                    torch.full((), -torch.inf, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngt,btnh->bngh", p, v.float())
    return out.to(q.dtype)


def flash_attention_ref(q, k, v, window: int = 0):
    """q: (B,nh,S,hd) pre-scaled; k/v: (B,n_kv,S,hd); causal (+SWA)."""
    b, nh, s, hd = q.shape
    n_kv = k.shape[1]
    qpk = nh // n_kv
    kr = torch.repeat_interleave(k, qpk, dim=1)
    vr = torch.repeat_interleave(v, qpk, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float())
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = ki <= qi
    if window:
        mask &= ki > qi - window
    logits = torch.where(mask[None, None], logits,
                         torch.full((), -torch.inf, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
    return out.to(q.dtype)
