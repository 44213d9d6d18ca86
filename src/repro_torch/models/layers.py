"""Shared neural building blocks of the dense path: RMSNorm, RoPE, GQA
attention (full / sliding-window / cached-decode), and the gated MLP.

PyTorch counterparts of ``repro.models.layers`` with the same names,
argument order and tensor layouts, so a parity test feeds both the same
numpy arrays.  Parameters are plain dicts of tensors.  The JAX package's
``shard()`` annotations have no counterpart on one GPU and are dropped;
``moe_mlp`` arrives with the MoE slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

# --------------------------------------------------------------------- norm


def rms_norm(x, w, eps: float = 1e-5):
    """RMSNorm with the variance reduction in f32; the scale is applied in
    the compute dtype (as the JAX package does)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    scale = (torch.rsqrt(var + eps) * w).to(x.dtype)
    return x * scale


# --------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float):
    """x: (..., S, n, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    ang = positions[..., None].float() * inv                # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention


def _qk_scale(head_dim: int) -> float:
    return head_dim ** -0.5


def gqa_attention(
    q,  # (B, S, nh, hd)
    k,  # (B, T, nkv, hd)
    v,  # (B, T, nkv, hd)
    *,
    causal_offset: Optional[int] = 0,
    window: int = 0,
    q_positions=None,   # (B, S) absolute positions of queries; default arange
    kv_valid=None,      # (B, T) bool mask of valid cache slots (decode)
    kv_positions=None,  # (B, T) absolute positions of cache slots (ring SWA)
):
    """Grouped-query attention with optional causal/sliding-window masking.

    Logits in f32 (bf16 products are exact in f32, as XLA's
    ``preferred_element_type=f32``); masked entries get -1e30; the
    probabilities are cast to the q dtype before the PV product.
    """
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qpk = nh // nkv
    qg = q.reshape(b, s, nkv, qpk, hd)

    logits = torch.einsum(
        "bsngh,btnh->bngst", qg.float(), k.float()
    ) * _qk_scale(hd)  # (B, nkv, qpk, S, T)

    if q_positions is None:
        q_pos = torch.arange(s, device=q.device)[None, :] + (causal_offset or 0)
        q_pos = q_pos.expand(b, s)
    else:
        q_pos = q_positions
    if kv_positions is None:
        k_pos = torch.arange(t, device=q.device)[None, :].expand(b, t)
    else:
        k_pos = kv_positions

    mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (B, S, T) causal
    if window:
        mask &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full((), -1e30, device=q.device))

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, v)
    return out.reshape(b, s, nh, hd)


def chunked_gqa_attention(
    q, k, v,
    *,
    window: int = 0,
    q_positions=None,
    kv_positions=None,
    kv_valid=None,
    chunk_q: int = 512,
    chunk_k: int = 1024,
):
    """Flash-style chunked attention in plain PyTorch (online softmax).

    Same semantics as ``gqa_attention`` with O(S*chunk) memory.  The JAX
    twin's context-parallel branch reduces to this sequential loop on one
    GPU.
    """
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qpk = nh // nkv
    dev = q.device
    # snap chunk sizes to divisors of s/t
    cq = s // max(1, s // min(chunk_q, s))
    ck = t // max(1, t // min(chunk_k, t))
    while s % cq:
        cq += 1
    while t % ck:
        ck += 1
    nq, nk = s // cq, t // ck

    if q_positions is None:
        q_positions = torch.arange(s, device=dev)[None].expand(b, s)
    if kv_positions is None:
        kv_positions = torch.arange(t, device=dev)[None].expand(b, t)
    if kv_valid is None:
        kv_valid = torch.ones((b, t), dtype=torch.bool, device=dev)

    qg = q.reshape(b, nq, cq, nkv, qpk, hd)
    kg = k.reshape(b, nk, ck, nkv, hd)
    vg = v.reshape(b, nk, ck, nkv, hd)
    qp = q_positions.reshape(b, nq, cq)
    kp = kv_positions.reshape(b, nk, ck)
    kva = kv_valid.reshape(b, nk, ck)
    scale = _qk_scale(hd)
    neg_inf = torch.full((), -torch.inf, device=dev)
    zero = torch.zeros((), device=dev)

    outs = []
    for iq in range(nq):
        q_c, qp_c = qg[:, iq], qp[:, iq]     # (B,cq,nkv,qpk,hd), (B,cq)
        m = torch.full((b, nkv, qpk, cq), -torch.inf, device=dev)
        l = torch.zeros((b, nkv, qpk, cq), device=dev)
        o = torch.zeros((b, nkv, qpk, cq, hd), device=dev)
        for ik in range(nk):
            k_c, v_c, kp_c, kva_c = kg[:, ik], vg[:, ik], kp[:, ik], kva[:, ik]
            s_ = torch.einsum(
                "bqngh,bknh->bngqk", q_c.float(), k_c.float()
            ) * scale                                   # (B,nkv,qpk,cq,ck)
            msk = (kp_c[:, None, :] <= qp_c[:, :, None]) & kva_c[:, None, :]
            if window:
                msk &= kp_c[:, None, :] > (qp_c[:, :, None] - window)
            s_ = torch.where(msk[:, None, None], s_, neg_inf)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            safe = torch.where(torch.isfinite(m_new), m_new, zero)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - safe), zero)
            p = torch.where(torch.isfinite(s_),
                            torch.exp(s_ - safe[..., None]), zero)
            l = alpha * l + p.sum(dim=-1)
            o = alpha[..., None] * o + torch.einsum(
                "bngqk,bknh->bngqh", p.to(v_c.dtype), v_c
            ).float()
            m = m_new
        out = o / torch.clamp(l, min=1e-30)[..., None]
        # (B,nkv,qpk,cq,hd) -> (B,cq,nh,hd)
        outs.append(torch.movedim(out, 3, 1).reshape(b, cq, nh, hd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_any(
    q, k, v, *, window=0, q_positions=None, kv_positions=None,
    kv_valid=None, full_threshold: int = 2048,
):
    """Dispatch: full-matrix attention for small S*T, chunked otherwise."""
    s, t = q.shape[1], k.shape[1]
    if s * t <= full_threshold * full_threshold or s == 1:
        return gqa_attention(
            q, k, v, window=window, q_positions=q_positions,
            kv_positions=kv_positions, kv_valid=kv_valid,
        )
    return chunked_gqa_attention(
        q, k, v, window=window, q_positions=q_positions,
        kv_positions=kv_positions, kv_valid=kv_valid,
    )


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int


def init_attention(gen: torch.Generator, d_model: int, dims: AttnDims,
                   dtype, device, lead: tuple = ()):
    """``lead``: leading shape of the leaves, e.g. ``(n_layers,)`` for the
    layer-stacked layout."""
    scale = d_model ** -0.5
    nh, nkv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim

    def normal(*shape):
        return (torch.randn((*lead, *shape), generator=gen, device=device)
                * scale).to(dtype)

    return {
        "wq": normal(d_model, nh, hd),
        "wk": normal(d_model, nkv, hd),
        "wv": normal(d_model, nkv, hd),
        "wo": normal(nh, hd, d_model),
    }


def attention_qkv(p, x, positions, theta: float, use_rope: bool):
    """Project and (optionally) rotate. x: (B,S,D) -> q,k,v (B,S,n,hd)."""
    b, s, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if use_rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def attention_out(p, o):
    b, s, nh, hd = o.shape
    return o.reshape(b, s, nh * hd) @ p["wo"].reshape(nh * hd, -1)


# ---------------------------------------------------------------------- mlp


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             lead: tuple = ()):
    def normal(shape, scale):
        return (torch.randn((*lead, *shape), generator=gen, device=device)
                * scale).to(dtype)

    return {
        "w1": normal((d_model, d_ff), d_model ** -0.5),
        "w3": normal((d_model, d_ff), d_model ** -0.5),
        "w2": normal((d_ff, d_model), d_ff ** -0.5),
    }


def gated_mlp(p, x):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]
