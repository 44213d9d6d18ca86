"""Plain PyTorch versions of the CUDA kernels.

The attention versions have the signatures and layouts of the JAX
package's ``kernels/ref.py``; ``mlstm_chunk_ref`` computes what the Pallas
``mlstm_chunk_kernel`` computes, with recurrent state in and out and any
sequence length.  The wrappers in ``ops.py`` run these for tensors on the
CPU, and the on-card checks hold each CUDA kernel against them.
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
    pad = -s % chunk
    qf, kf, vf = q.float(), k.float() * hd ** -0.5, v.float()
    ig, fg = i_raw.float(), log_f.float()
    if pad:
        qf, kf, vf = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                      for x in (qf, kf, vf))
        ig = torch.nn.functional.pad(ig, (0, pad), value=MLSTM_NEG)
        fg = torch.nn.functional.pad(fg, (0, pad), value=0.0)
    c_st, n_st, m_st = state if state is not None else empty_mlstm_state(
        b, h, hd, dev)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    neg_inf = torch.full((), -torch.inf, device=dev)
    outs = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
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
        den_sum = sw.sum(dim=-1) + inter * (q_c @ n_st[..., None])[..., 0]
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
    out = torch.cat(outs, dim=2)[:, :, :s]
    return out.to(q.dtype), (c_st, n_st, m_st)
