"""Shared neural building blocks of the dense path: RMSNorm, RoPE, GQA
attention (full / sliding-window / cached-decode), and the gated MLP.

PyTorch counterparts of ``repro.models.layers`` with the same names,
argument order and tensor layouts, so a parity test feeds both the same
numpy arrays.  Parameters are plain dicts of tensors.  The JAX package's
``shard()`` annotations stand where JAX has them (``models/shardlib``):
the identity on plain tensors, a redistribution of a DTensor under a
sharded plan, where the products run on local shards
(``shardlib.local_call``) and the attention core on shards that hold
whole heads.  The GShard MoE (``init_moe``, ``moe_mlp``) is plain
PyTorch, as the JAX package computes it in jnp outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ref import rms_norm_ref, rope_rotate
from repro_torch.launch.op_analysis import expand, loop_weights, repeated
from repro_torch.models.shardlib import active_rules, local_call, shard

# --------------------------------------------------------------------- norm


def rms_norm(x, w, eps: float = 1e-5):
    """RMSNorm with the variance reduction in f32; the scale is applied in
    the compute dtype (as the JAX package does): ``ref.rms_norm_ref``,
    which the decode glue's kernel is held to."""
    return rms_norm_ref(x, w, eps)


# --------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_tables(positions, head_dim: int, theta: float, device=None):
    """cos and sin of the rotary angles at ``positions`` (..., S), each
    (..., S, 1, hd/2) float32: what ``apply_rope`` rotates by.  A decode
    step builds them once for every layer (``rope_kv_write``)."""
    inv = rope_freqs(head_dim, theta, device=device)        # (hd/2,)
    ang = positions[..., None].float() * inv                # (..., S, hd/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x, positions, theta: float):
    """x: (..., S, n, hd); positions: broadcastable to (..., S)."""
    return rope_rotate(x, *rope_tables(positions, x.shape[-1], theta,
                                       device=x.device))


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
    probabilities are cast to the q dtype before the PV product.  On
    DTensors the two products run on local shards (``_ein``) and the rest
    is DTensor's: a head dim split over the mesh leaves the logits
    ``Partial`` (reduced before the mask, as the JAX package's SPMD
    reduces them), and a cache sequence split over the mesh (JAX's O3)
    gathers only the probabilities' softmax dim, never the cache.
    """
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qpk = nh // nkv
    qg = q.reshape(b, s, nkv, qpk, hd)

    logits = _ein(
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

    # out of place: a plain mask meets the DTensor masks of a sharded plan
    mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (B, S, T) causal
    if window:
        mask = mask & (k_pos[:, None, :] > (q_pos[:, :, None] - window))
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full((), -1e30, device=q.device))

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = _ein("bngst,btnh->bsngh", probs, v)
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

    Same semantics as ``gqa_attention`` with O(S*chunk) memory: a loop
    over q chunks, each an online softmax over the k chunks.  Context
    parallelism (the JAX package's §Perf O4): where the active rules map
    the logical ``"q_chunks"`` axis to a mesh axis, the q chunks are
    stacked into a dim sharded on it and each device runs the loop over
    its own chunks (nq forced to a multiple of that axis's degree);
    otherwise one loop runs over all chunks, on shards holding whole heads
    where the inputs are DTensors.
    """
    b, s, nh, hd = q.shape
    t = k.shape[1]
    dev = q.device
    cp_degree = 0
    ctx = active_rules()
    if ctx is not None:
        mesh, rules = ctx
        ax = rules.get("q_chunks")
        if ax is not None:
            cp_degree = 1
            names = list(mesh.mesh_dim_names)
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                cp_degree *= mesh.size(names.index(a))
    # snap chunk sizes to divisors of s/t
    cq = s // max(1, s // min(chunk_q, s))
    ck = t // max(1, t // min(chunk_k, t))
    while s % cq:
        cq += 1
    while t % ck:
        ck += 1
    nq = s // cq
    if cp_degree > 1:
        # force nq to a multiple of the context-parallel degree
        nq2 = ((max(nq, cp_degree) + cp_degree - 1) // cp_degree) * cp_degree
        while nq2 <= s and s % nq2:
            nq2 += cp_degree
        if nq2 <= s:
            nq = nq2
            cq = s // nq
        else:
            cp_degree = 0  # cannot split this length: one loop

    if q_positions is None:
        q_positions = torch.arange(s, device=dev)[None].expand(b, s)
    if kv_positions is None:
        kv_positions = torch.arange(t, device=dev)[None].expand(b, t)
    if kv_valid is None:
        kv_valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    # pin the K/V layout outside the chunk loops (JAX: layers.py kg/vg)
    k = shard(k, "batch", None, "kv_heads", "head_dim")
    v = shard(v, "batch", None, "kv_heads", "head_dim")
    loop = functools.partial(_q_chunk_loop, window=window, ck=ck)
    if cp_degree > 1:
        qg = shard(q.reshape(b, nq, cq, nh, hd),
                   "batch", "q_chunks", None, None, None)
        qp = shard(q_positions.reshape(b, nq, cq), "batch", "q_chunks", None)
        outs = local_call(loop, "bcqnh,bcq,btnh,btnh,bt,bt->bcqnh", qg, qp,
                          k, v, kv_positions, kv_valid, keep="bcn",
                          split="n")
        outs = shard(outs, "batch", "q_chunks", None, None, None)
        return outs.reshape(b, s, nh, hd)
    qg = q.reshape(b, nq, cq, nh, hd)
    qp = q_positions.reshape(b, nq, cq)
    outs = local_call(loop, "bcqnh,bcq,btnh,btnh,bt,bt->bcqnh", qg, qp, k, v,
                      kv_positions, kv_valid, keep="bn", split="n")
    return outs.reshape(b, s, nh, hd)


def _q_chunk_loop(qg, qp, k, v, kv_positions, kv_valid, *, window: int,
                  ck: int):
    """The online-softmax loop of ``chunked_gqa_attention`` over the q
    chunks ``qg`` (B, nq, cq, nh, hd) at positions ``qp`` (B, nq, cq):
    returns (B, nq, cq, nh, hd)."""
    b, nq, cq, nh, hd = qg.shape
    t, nkv = k.shape[1], k.shape[2]
    qpk = nh // nkv
    nk = t // ck
    qg = qg.reshape(b, nq, cq, nkv, qpk, hd)
    kg = k.reshape(b, nk, ck, nkv, hd)
    vg = v.reshape(b, nk, ck, nkv, hd)
    kp = kv_positions.reshape(b, nk, ck)
    kva = kv_valid.reshape(b, nk, ck)

    # identical iterations: a counted meta run takes three of each loop
    wq, wk = loop_weights(nq, qg), loop_weights(nk, qg)
    outs = []
    for iq, w in enumerate(wq):
        with repeated(w):
            outs.append(_one_q_chunk(qg[:, iq], qp[:, iq], kg, vg, kp, kva,
                                     window, wk))
    return torch.stack(expand(outs, wq), dim=1)


def _one_q_chunk(q_c, qp_c, kg, vg, kp, kva, window: int, wk: list):
    """One q chunk (B,cq,nkv,qpk,hd) against the k chunks: (B,cq,nh,hd).
    Where autograd records, each k chunk's step is recomputed in the
    backward pass, as the JAX package checkpoints it."""
    b, cq, nkv, qpk, hd = q_c.shape
    dev = q_c.device
    m = torch.full((b, nkv, qpk, cq), -torch.inf, device=dev)
    l = torch.zeros((b, nkv, qpk, cq), device=dev)
    o = torch.zeros((b, nkv, qpk, cq, hd), device=dev)
    step = functools.partial(_k_chunk_step, window=window)
    if torch.is_grad_enabled() and q_c.requires_grad:
        step = functools.partial(checkpoint, step, use_reentrant=False)
    for ik, w in enumerate(wk):
        with repeated(w):
            m, l, o = step(m, l, o, q_c, qp_c, kg[:, ik], vg[:, ik],
                           kp[:, ik], kva[:, ik])
    out = o / torch.clamp(l, min=1e-30)[..., None]
    # (B,nkv,qpk,cq,hd) -> (B,cq,nh,hd)
    return torch.movedim(out, 3, 1).reshape(b, cq, nkv * qpk, hd).to(
        q_c.dtype)


def _k_chunk_step(m, l, o, q_c, qp_c, k_c, v_c, kp_c, kva_c, *, window):
    """One online-softmax step of a q chunk over a k chunk: the new
    running max, normaliser and output (m, l, o)."""
    dev = q_c.device
    neg_inf = torch.full((), -torch.inf, device=dev)
    zero = torch.zeros((), device=dev)
    s_ = torch.einsum(
        "bqngh,bknh->bngqk", q_c.float(), k_c.float()
    ) * _qk_scale(q_c.shape[-1])                    # (B,nkv,qpk,cq,ck)
    msk = (kp_c[:, None, :] <= qp_c[:, :, None]) & kva_c[:, None, :]
    if window:
        msk &= kp_c[:, None, :] > (qp_c[:, :, None] - window)
    s_ = torch.where(msk[:, None, None], s_, neg_inf)
    m_new = torch.maximum(m, s_.amax(dim=-1))
    safe = torch.where(torch.isfinite(m_new), m_new, zero)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe), zero)
    p = torch.where(torch.isfinite(s_), torch.exp(s_ - safe[..., None]),
                    zero)
    l = alpha * l + p.sum(dim=-1)
    o = alpha[..., None] * o + torch.einsum(
        "bngqk,bknh->bngqh", p.to(v_c.dtype), v_c
    ).float()
    return m_new, l, o


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


def stacked_normal(gen: torch.Generator, lead: tuple, shape: tuple,
                   scale: float, dtype, device):
    """A ``(*lead, *shape)`` tensor of ``dtype`` filled with scaled normal
    draws one leading index at a time: each ``shape`` part is drawn in
    float32, scaled and cast into the preallocated stack, so that a float32
    draw of the whole stack (twice a bfloat16 stack's size, and a scaled
    copy beside it) never exists."""
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    for part in out.view(-1, *shape):
        part.copy_(torch.randn(shape, generator=gen, device=device) * scale)
    return out


def init_attention(gen: torch.Generator, d_model: int, dims: AttnDims,
                   dtype, device, lead: tuple = ()):
    """``lead``: leading shape of the leaves, e.g. ``(n_layers,)`` for the
    layer-stacked layout (drawn one layer at a time)."""
    scale = d_model ** -0.5
    nh, nkv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim

    def normal(*shape):
        return stacked_normal(gen, lead, shape, scale, dtype, device)

    return {
        "wq": normal(d_model, nh, hd),
        "wk": normal(d_model, nkv, hd),
        "wv": normal(d_model, nkv, hd),
        "wo": normal(nh, hd, d_model),
    }


def _project_heads(x, w):
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def project_heads(x, w):
    """x: (B,S,D) @ w: (D,n,hd) -> (B,S,n,hd) (JAX: einsum bsd,dnh->bsnh)."""
    return local_call(_project_heads, "bsd,dnh->bsnh", x, w)


def matmul(x, w, sig: str):
    """``x @ w``, on local shards where either is a DTensor; ``sig`` names
    the dims (``"bsd,df->bsf"``)."""
    return local_call(torch.matmul, sig, x, w)


def attention_qkv(p, x, positions, theta: float, use_rope: bool):
    """Project and (optionally) rotate. x: (B,S,D) -> q,k,v (B,S,n,hd)."""
    q, k, v = (project_heads(x, p[w]) for w in ("wq", "wk", "wv"))
    ctxr = active_rules()
    if ctxr is not None and ctxr[1].get("head_dim_proj") is not None:
        # the JAX package's context-parallel projection pin (its §Perf
        # O4/iteration 5, kept disabled by the rules)
        q = shard(q, "batch", "seq", "heads", "head_dim_proj")
        k = shard(k, "batch", "seq", "kv_heads", "head_dim_proj")
        v = shard(v, "batch", "seq", "kv_heads", "head_dim_proj")
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    if use_rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _attention_out(o, wo):
    b, s, nh, hd = o.shape
    return o.reshape(b, s, nh * hd) @ wo.reshape(nh * hd, -1)


def attention_out(p, o):
    y = local_call(_attention_out, "bsnh,nhd->bsd", o, p["wo"])
    return shard(y, "batch", "seq", "embed")


# ---------------------------------------------------------------------- mlp


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             lead: tuple = ()):
    def normal(shape, scale):
        return stacked_normal(gen, lead, shape, scale, dtype, device)

    return {
        "w1": normal((d_model, d_ff), d_model ** -0.5),
        "w3": normal((d_model, d_ff), d_model ** -0.5),
        "w2": normal((d_ff, d_model), d_ff ** -0.5),
    }


def gated_mlp(p, x):
    h = F.silu(matmul(x, p["w1"], "bsd,df->bsf")) * matmul(
        x, p["w3"], "bsd,df->bsf")
    h = shard(h, "batch", "seq", "ffn")
    y = matmul(h, p["w2"], "bsf,fd->bsd")
    return shard(y, "batch", "seq", "embed")


# ---------------------------------------------------------------------- moe


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype, device, lead: tuple = ()):
    """The router (float32, as JAX keeps it) and the stacked expert
    weights ``(*lead, E, ...)``, drawn one layer at a time
    (``stacked_normal``)."""

    def normal(shape, scale, dt):
        return stacked_normal(gen, lead, shape, scale, dt, device)

    return {
        "router": normal((d_model, n_experts), d_model ** -0.5,
                         torch.float32),
        "w1": normal((n_experts, d_model, d_ff), d_model ** -0.5, dtype),
        "w3": normal((n_experts, d_model, d_ff), d_model ** -0.5, dtype),
        "w2": normal((n_experts, d_ff, d_model), d_ff ** -0.5, dtype),
    }


def top_k_lower_index_first(x, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, equal values lower index first (a stable descending
    sort; ``torch.topk`` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ein(eq: str, a, b):
    """``torch.einsum(eq, a, b)``, on local shards where either is a
    DTensor."""
    return local_call(functools.partial(torch.einsum, eq), eq, a, b)


def _moe_route(xg, router, *, top_k: int, cap: int):
    """The MoE's routing per (row, group): dispatch and combine tensors
    (B,G,g,E,C), the per-token expert counts and router probabilities
    (B,G,g,E) for the load-balance term."""
    e = router.shape[-1]
    b, ng, g, _ = xg.shape
    gate_logits = torch.einsum("bngd,de->bnge", xg.float(), router)
    probs = torch.softmax(gate_logits, dim=-1)               # (B,G,g,E)
    gate_vals, gate_idx = top_k_lower_index_first(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # position of each (token, k) within its expert's capacity buffer
    onehot = F.one_hot(gate_idx, e).float()                  # (B,G,g,K,E)
    flat = onehot.reshape(b, ng, g * top_k, e)
    pos_in_expert = torch.cumsum(flat, dim=2) * flat - 1.0
    pos_in_expert = pos_in_expert.reshape(b, ng, g, top_k, e)
    fits = (pos_in_expert >= 0) & (pos_in_expert < cap)
    slot = F.one_hot(torch.clamp(pos_in_expert, 0, cap - 1).long(), cap)
    kept = onehot * fits
    disp = (slot.to(xg.dtype) * kept[..., None].to(xg.dtype)).sum(dim=3)
    comb = (slot.float() * (kept * gate_vals[..., None])[..., None]
            ).sum(dim=3).to(xg.dtype)                        # (B,G,g,E,C)
    return disp, comb, onehot.sum(3), probs


def moe_mlp(p, x, *, top_k: int, capacity_factor: float = 1.25,
            group_size: int = 1024):
    """GShard-style capacity-based top-k MoE, grouped along the sequence;
    returns ``(y, aux)``, aux the Switch load-balance loss term.

    The rules of the JAX ``moe_mlp``: groups of the divisor-snapped size
    ``g``, an expert buffer of ``max(1, int(g * top_k / E * cf))`` tokens,
    router product and softmax in float32, the top-k gates renormalised
    with a 1e-9 floor, each (token, k)'s place in its expert's buffer a
    cumsum in token-major, k-minor order, and a token that does not fit
    falling through the residual (its output from that expert is 0).
    Padded tokens come after a row's real ones, so they never take a real
    token's place.
    """
    b, s, d = x.shape
    e = p["router"].shape[-1]
    g = s // max(1, s // min(group_size, s))   # divisor-snapped group size
    while s % g:
        g += 1
    ng = s // g
    cap = max(1, int(g * top_k / e * capacity_factor))

    xg = x.reshape(b, ng, g, d)
    route = functools.partial(_moe_route, top_k=top_k, cap=cap)
    disp, comb, counts, probs = local_call(
        route, "bngd,de->bngec,bngec,bnge,bnge", xg, p["router"], keep="bn")

    xe = _ein("bngd,bngec->bnecd", xg, disp)                # (B,G,E,C,D)
    # expert-parallel archs shard E ("experts"->model, "ffn"->None);
    # few-expert archs shard F instead (the JAX package's rules)
    xe = shard(xe, "batch", None, "experts", None, None)
    h = F.silu(_ein("bnecd,edf->bnecf", xe, p["w1"])) * _ein(
        "bnecd,edf->bnecf", xe, p["w3"])
    h = shard(h, "batch", None, "experts", None, "ffn")
    ye = _ein("bnecf,efd->bnecd", h, p["w2"])
    y = _ein("bnecd,bngec->bngd", ye, comb).reshape(b, s, d)
    y = shard(y, "batch", "seq", "embed")

    frac_tokens = counts.mean(dim=(0, 1, 2))                 # (E,)
    frac_probs = probs.mean(dim=(0, 1, 2))                   # (E,)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y, aux
