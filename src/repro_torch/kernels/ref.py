"""Plain PyTorch versions of the CUDA kernels.

The attention versions have the signatures and layouts of the JAX
package's ``kernels/ref.py``; ``mlstm_chunk_ref`` computes what the Pallas
``mlstm_chunk_kernel`` computes, with recurrent state in and out and any
sequence length.  The decode glue's pieces are defined here and the
models call them: ``rms_norm_ref`` is ``layers.rms_norm``, ``rope_rotate``
the rotation of ``layers.apply_rope``, ``write_rows`` and ``put_rows`` the
writes of ``transformer.update_cache`` and ``update_pos`` on plain
tensors; ``rope_kv_write_ref`` and ``silu_mul_ref`` compose them as the
decode block does.  The wrappers in ``ops.py`` run these for tensors on
the CPU, and the on-card checks hold each CUDA kernel against them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import split_tiles
from repro_torch.launch.op_analysis import expand, loop_weights, repeated


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


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths,
                              n_split: int):
    """What the split bf16 CUDA kernel computes, in plain PyTorch: each
    sequence's live tokens cut into 16-token tiles, tile g to block g %
    ``n_split`` (``split_tiles``), a partial softmax state
    (m, l, acc) per block over its tiles (a block with none gives m =
    -inf, l = 0), and their merge, floored at l = 1e-30 (so length 0 gives
    0).  Same arguments and result as ``paged_attention_ref``."""
    b, n_kv, qpk, hd = q.shape
    max_pages = block_tables.shape[1]
    bs = k_pages.shape[1]
    tables = torch.clamp(block_tables.long(), 0, k_pages.shape[0] - 1)
    k = k_pages[tables].reshape(b, max_pages * bs, n_kv, hd).float()
    v = v_pages[tables].reshape(b, max_pages * bs, n_kv, hd).float()
    s_all = torch.einsum("bngh,btnh->bngt", q.float(), k)
    # block r's tokens: its tiles of each row's live tokens
    mine = torch.zeros((n_split, b, max_pages * bs), dtype=torch.bool)
    for row, length in enumerate(lengths.tolist()):
        length = min(max(length, 0), max_pages * bs)
        for r, tiles in enumerate(split_tiles(length, n_split)):
            for t0, t1 in tiles:
                mine[r, row, t0:t1] = True
    mine = mine.to(q.device)
    neg_inf = torch.full((), -torch.inf, device=q.device)
    m = torch.full((b, n_kv, qpk), -torch.inf, device=q.device)
    l = torch.zeros((b, n_kv, qpk), device=q.device)
    acc = torch.zeros((b, n_kv, qpk, hd), device=q.device)
    for r in range(n_split):
        s = torch.where(mine[r, :, None, None, :], s_all, neg_inf)
        m_r = s.amax(dim=-1)
        p = torch.exp(s - torch.where(m_r == -torch.inf, 0.0, m_r)[..., None])
        l_r = p.sum(dim=-1)
        acc_r = torch.einsum("bngt,btnh->bngh", p, v)
        m_new = torch.maximum(m, m_r)
        use = torch.where(m_new == -torch.inf, 0.0, m_new)
        a, c = torch.exp(m - use), torch.exp(m_r - use)
        l = a * l + c * l_r
        acc = a[..., None] * acc + c[..., None] * acc_r
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def rms_norm_ref(x, w, eps: float, residual=None):
    """RMSNorm over the last dim with the variance reduction in float32
    and the scale applied in the compute dtype, as the JAX package does
    (``layers.rms_norm``); with ``residual`` the pair ``(x + residual,
    rms_norm(x + residual))``."""
    if residual is not None:
        x = x + residual
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    scale = (torch.rsqrt(var + eps) * w).to(x.dtype)
    return x * scale if residual is None else (x, x * scale)


def rope_rotate(x, cos, sin):
    """x (..., hd) rotated by the angles whose ``cos`` and ``sin`` (...,
    hd/2) are given, in float32, cast back to x's dtype: the halves (x1,
    x2) become (x1 cos - x2 sin, x1 sin + x2 cos)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def write_rows(pos, t: int, s: int):
    """Row indices ``(B, S)`` of an S-row write at offsets ``pos`` into a
    T-row cache, clamped like ``jax.lax.dynamic_update_slice`` (the start
    moves so the whole slice fits)."""
    start = torch.clamp(pos.long(), 0, t - s)
    return start[:, None] + torch.arange(s, device=pos.device)


def put_rows(cache, rows, new):
    """``cache[b, rows[b, i]] = new[b, i]`` in place, cast to the cache's
    dtype; returns ``cache``."""
    bi = torch.arange(cache.shape[0], device=rows.device)[:, None]
    cache[bi, rows] = new.to(cache.dtype)
    return cache


def rope_kv_write_ref(q, k, v, cos, sin, pos, k_cache, v_cache, kv_pos):
    """One decode token's RoPE and cache writes, as the decode block makes
    them: q and k rotated by the step's tables (``layers.rope_tables``),
    then k and v written into row ``clamp(pos, 0, T-1)`` of the caches and
    ``pos`` into ``kv_pos`` there, in place.  q, k, v (B, 1, n, hd); cos,
    sin (B, 1, 1, hd/2).  Returns the rotated q as (B, nh, hd)."""
    rows = write_rows(pos, k_cache.shape[1], 1)
    put_rows(k_cache, rows, rope_rotate(k, cos, sin))
    put_rows(v_cache, rows, v)
    put_rows(kv_pos, rows, pos[:, None])
    return rope_rotate(q, cos, sin)[:, 0]


def silu_mul_ref(a, b):
    """The gated MLP's ``F.silu(a) * b``."""
    return F.silu(a) * b


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


#: the mLSTM stabiliser's start (``m`` of an empty state) and the input gate
#: of a padding token: large and negative but finite, so that no
#: ``-inf - -inf`` can arise
MLSTM_NEG = -1e30


def empty_mlstm_state(b: int, h: int, hd: int, device=None):
    """Empty mLSTM state: C (B,H,hd,hd) and n (B,H,hd) zero, m (B,H) at
    ``MLSTM_NEG``, all float32."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((b, h, hd, hd), **f32),
            torch.zeros((b, h, hd), **f32),
            torch.full((b, h), MLSTM_NEG, **f32))


def _mlstm_padded(q, k, v, i_raw, log_f, chunk: int):
    """q, k * hd^-0.5, v and the gates in float32, padded to whole chunks
    with tokens that neither decay nor add (log_f = 0, i_raw =
    ``MLSTM_NEG``, q = k = v = 0)."""
    s, hd = q.shape[2], q.shape[3]
    pad = -s % chunk
    qf, kf, vf = q.float(), k.float() * hd ** -0.5, v.float()
    ig, fg = i_raw.float(), log_f.float()
    if pad:
        qf, kf, vf = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                      for x in (qf, kf, vf))
        ig = torch.nn.functional.pad(ig, (0, pad), value=MLSTM_NEG)
        fg = torch.nn.functional.pad(fg, (0, pad), value=0.0)
    return qf, kf, vf, ig, fg


def mlstm_chunk_ref(q, k, v, i_raw, log_f, state=None, *, chunk: int = 64):
    """Chunkwise-parallel mLSTM; returns ``(h, (C, n, m))``.

    q, k, v: (B, H, S, hd) in any float type; i_raw, log_f: (B, H, S);
    state: ``(C (B,H,hd,hd), n (B,H,hd), m (B,H))`` in float32, or None for
    the empty state.  k is scaled by hd^-0.5 inside.  Any S: the last chunk
    is padded with tokens that neither decay nor add (log_f = 0,
    i_raw = ``MLSTM_NEG``), so the state handed on is that after token
    S - 1.  Math in float32; h comes back in q's dtype.
    """
    b, h, s, hd = q.shape
    dev = q.device
    qf, kf, vf, ig, fg = _mlstm_padded(q, k, v, i_raw, log_f, chunk)
    c_st, n_st, m_st = state if state is not None else empty_mlstm_state(
        b, h, hd, dev)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    neg_inf = torch.full((), -torch.inf, device=dev)
    outs = []
    n_chunks = qf.shape[2] // chunk
    weights = loop_weights(n_chunks, qf)
    for i, reps in enumerate(weights):
        with repeated(reps):
            sl = slice(i * chunk, (i + 1) * chunk)
            q_c, k_c, v_c = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl]
            i_c, f_c = ig[:, :, sl], fg[:, :, sl]
            fcum = torch.cumsum(f_c, dim=-1)                     # F_t
            d = fcum[..., :, None] - fcum[..., None, :] + i_c[..., None, :]
            d = torch.where(causal, d, neg_inf)                  # (B,H,t,j)
            m_inter = fcum + m_st[..., None]
            m_t = torch.maximum(d.amax(dim=-1), m_inter)
            w = torch.exp(d - m_t[..., None])
            inter = torch.exp(m_inter - m_t)
            sw = (q_c @ k_c.transpose(-1, -2)) * w
            num = sw @ v_c + inter[..., None] * (q_c @ c_st)
            den_sum = (sw.sum(dim=-1)
                       + inter * (q_c @ n_st[..., None])[..., 0])
            den = torch.maximum(den_sum.abs(), torch.exp(-m_t))
            outs.append(num / den[..., None])
            # chunk-final state handoff
            m_new = m_t[..., -1]
            wj = torch.exp(fcum[..., -1:] - fcum + i_c - m_new[..., None])
            decay = torch.exp(m_inter[..., -1] - m_new)
            kw = k_c * wj[..., None]
            c_st = decay[..., None, None] * c_st + kw.transpose(-1, -2) @ v_c
            n_st = decay[..., None] * n_st + kw.sum(dim=-2)
            m_st = m_new
    out = torch.cat(expand(outs, weights), dim=2)[:, :, :s]
    return out.to(q.dtype), (c_st, n_st, m_st)


def mlstm_states_pass_ref(k, v, i_raw, log_f, state=None, *,
                          chunk: int = 64):
    """The first pass of the two-pass chunkwise mLSTM: the chunk walk from
    the gates, k and v alone.  Returns ``(starts, final)``: every chunk's
    starting ``(C (B,H,NC,hd,hd), n (B,H,NC,hd), m (B,H,NC))``, chunk 0's
    being ``state``, and the final ``(C, n, m)``; NC = ceil(S / chunk).
    The handoff is ``mlstm_chunk_ref``'s, term for term."""
    b, h, s, hd = k.shape
    dev = k.device
    _, kf, vf, ig, fg = _mlstm_padded(k, k, v, i_raw, log_f, chunk)
    nc = kf.shape[2] // chunk
    kc = kf.reshape(b, h, nc, chunk, hd)
    vc = vf.reshape(b, h, nc, chunk, hd)
    fcum = torch.cumsum(fg.reshape(b, h, nc, chunk), dim=-1)   # F_t
    # F_last - F_j + i_j, whose max and weights the handoff takes
    u = fcum[..., -1:] - fcum + ig.reshape(b, h, nc, chunk)
    c_st, n_st, m_st = state if state is not None else empty_mlstm_state(
        b, h, hd, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    starts = (torch.empty((b, h, nc, hd, hd), **f32),
              torch.empty((b, h, nc, hd), **f32),
              torch.empty((b, h, nc), **f32))
    for j in range(nc):
        for start, x in zip(starts, (c_st, n_st, m_st)):
            start[:, :, j] = x
        m_inter = fcum[:, :, j, -1] + m_st
        m_new = torch.maximum(u[:, :, j].amax(dim=-1), m_inter)
        wj = torch.exp(u[:, :, j] - m_new[..., None])
        decay = torch.exp(m_inter - m_new)
        kw = kc[:, :, j] * wj[..., None]
        c_st = (decay[..., None, None] * c_st
                + kw.transpose(-1, -2) @ vc[:, :, j])
        n_st = decay[..., None] * n_st + kw.sum(dim=-2)
        m_st = m_new
    return starts, (c_st, n_st, m_st)


def mlstm_outputs_pass_ref(q, k, v, i_raw, log_f, starts, *,
                           chunk: int = 64):
    """The second pass: every chunk's h at once from its starting
    ``(C, n, m)`` (``mlstm_states_pass_ref``'s ``starts``); no chunk reads
    another.  Returns h (B, H, S, hd) in q's dtype."""
    b, h, s, hd = q.shape
    dev = q.device
    qf, kf, vf, ig, fg = _mlstm_padded(q, k, v, i_raw, log_f, chunk)
    nc = qf.shape[2] // chunk
    qc, kc, vc = (x.reshape(b, h, nc, chunk, hd) for x in (qf, kf, vf))
    ic = ig.reshape(b, h, nc, chunk)
    fcum = torch.cumsum(fg.reshape(b, h, nc, chunk), dim=-1)
    c0, n0, m0 = starts
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    d = fcum[..., :, None] - fcum[..., None, :] + ic[..., None, :]
    d = torch.where(causal, d, torch.full((), -torch.inf, device=dev))
    m_inter = fcum + m0[..., None]
    m_t = torch.maximum(d.amax(dim=-1), m_inter)
    w = torch.exp(d - m_t[..., None])
    inter = torch.exp(m_inter - m_t)
    sw = (qc @ kc.transpose(-1, -2)) * w
    num = sw @ vc + inter[..., None] * (qc @ c0)
    den_sum = sw.sum(dim=-1) + inter * (qc @ n0[..., None])[..., 0]
    den = torch.maximum(den_sum.abs(), torch.exp(-m_t))
    out = (num / den[..., None]).reshape(b, h, nc * chunk, hd)[:, :, :s]
    return out.to(q.dtype)


def mlstm_chunk_twopass_ref(q, k, v, i_raw, log_f, state=None, *,
                            chunk: int = 64):
    """What the tensor-core mLSTM kernel computes, in plain PyTorch: the
    states pass, then the outputs pass from its chunks' starting states.
    Same arguments and result as ``mlstm_chunk_ref``.  (The kernel carries
    w v, each chunk's starting C and q.k^T * W to its bf16 tensor-core
    products as hi + lo pairs, exact to about 2^-16; this version keeps them
    in float32.)"""
    starts, final = mlstm_states_pass_ref(k, v, i_raw, log_f, state,
                                          chunk=chunk)
    return mlstm_outputs_pass_ref(q, k, v, i_raw, log_f, starts,
                                  chunk=chunk), final
