"""xLSTM sequence mixers of the port: the mLSTM and sLSTM blocks.

PyTorch counterparts of the xLSTM part of ``repro.models.ssm``, with the
same names, argument order, parameter keys and state layouts (per layer):

  mlstm:   C: (B, H, hd, hd)  n: (B, H, hd)  m: (B, H)
  slstm:   c, n, h: (B, H, hd)  m: (B, H, hd)

The chunkwise mLSTM of prefill runs through ``ops.mlstm_chunk``: the CUDA
kernel on the card, its plain version on the CPU.  The projections and
gates around it are plain matrix products, as the JAX package leaves them
to XLA.  The per-step forms (``mlstm_forward``, ``mlstm_decode``) and the
whole sLSTM are plain PyTorch: no Pallas kernel computes them.
``slstm_forward`` projects the whole input once and then loops over the
recurrent step token by token, as the JAX ``lax.scan`` does.  Mamba2 (the
hybrid family) is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import mlstm_chunk
from repro_torch.kernels.ref import empty_mlstm_state

#: tokens per chunk of the chunkwise mLSTM (the kernel's largest tile); any
#: prompt length runs, the last chunk masked
MLSTM_CHUNK = 64


def _normal(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _proj(x, w):
    """x: (B,S,D) @ w: (D,H,hd) -> (B,S,H,hd) (JAX: einsum bsd,dhk->bshk)."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def _out(h, wo):
    """h: (B,S,H,hd) @ wo: (H,hd,D) -> (B,S,D) (JAX: bshk,hkd->bsd)."""
    b, s = h.shape[:2]
    return h.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def rms_head_norm(h, w):
    h32 = h.float()
    y = h32 * torch.rsqrt(torch.mean(h32 * h32, dim=-1, keepdim=True) + 1e-5)
    return (y * w).to(h.dtype)


# -------------------------------------------------------------------- mlstm


def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int,
               head_dim: int, dtype, device=None, lead: tuple = ()):
    """``lead``: leading shape of the leaves, e.g. ``(n_pairs,)`` for the
    pair-stacked layout.  The gate projection, its bias and the head norm
    stay float32, as in the JAX package."""
    scale = d_model ** -0.5
    f32 = torch.float32
    qkv = (*lead, d_model, n_heads, head_dim)
    return {
        "wq": _normal(gen, qkv, scale, dtype, device),
        "wk": _normal(gen, qkv, scale, dtype, device),
        "wv": _normal(gen, qkv, scale, dtype, device),
        "w_if": _normal(gen, (*lead, d_model, n_heads, 2), scale, f32,
                        device),
        # forget gate biased open
        "b_if": torch.tensor([0.0, 3.0], dtype=f32, device=device).expand(
            *lead, n_heads, 2).clone(),
        "wo": _normal(gen, (*lead, n_heads, head_dim, d_model),
                      (n_heads * head_dim) ** -0.5, dtype, device),
        "norm_w": torch.ones((*lead, n_heads, head_dim), dtype=f32,
                             device=device),
    }


def _mlstm_gates(p, x):
    """x: (B,S,D) -> i_raw, log_f: (B,S,H) float32."""
    b, s, d = x.shape
    g = (x.float() @ p["w_if"].reshape(d, -1)).reshape(
        b, s, *p["w_if"].shape[1:]) + p["b_if"]
    return g[..., 0], F.logsigmoid(g[..., 1])


def mlstm_init_state(p, batch: int):
    n_heads, hd = p["norm_w"].shape
    return empty_mlstm_state(batch, n_heads, hd, p["norm_w"].device)


def _mlstm_step(state, q_t, k_t, v_t, i_t, f_t):
    """One stabilised recurrent step; q/k/v_t: (B,H,hd), i/f_t: (B,H).
    Returns the new state and h_t (B,H,hd) in float32."""
    c, n, m = state
    hd = q_t.shape[-1]
    m_new = torch.maximum(f_t + m, i_t)
    alpha = torch.exp(f_t + m - m_new)
    beta = torch.exp(i_t - m_new)
    kf = k_t.float() / math.sqrt(hd)
    c = c * alpha[..., None, None] + beta[..., None, None] * (
        kf[..., :, None] * v_t.float()[..., None, :])
    n = n * alpha[..., None] + beta[..., None] * kf
    qf = q_t.float()
    num = (qf[..., None, :] @ c)[..., 0, :]
    den = torch.maximum((qf * n).sum(dim=-1).abs(), torch.exp(-m_new))
    return (c, n, m_new), num / den[..., None]


def mlstm_forward(p, x, state=None):
    """Recurrent full-sequence form, one step per token (the oracle of the
    chunkwise form).  Returns (y (B,S,D), final_state)."""
    b, s, _ = x.shape
    q, k, v = (_proj(x, p[w]) for w in ("wq", "wk", "wv"))
    i_raw, log_f = _mlstm_gates(p, x)
    if state is None:
        state = mlstm_init_state(p, b)
    hs = []
    for t in range(s):
        state, h_t = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                 i_raw[:, t], log_f[:, t])
        hs.append(h_t)
    h = rms_head_norm(torch.stack(hs, dim=1).to(x.dtype), p["norm_w"])
    return _out(h, p["wo"]), state


def mlstm_forward_chunked(p, x, state=None, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM from ``state`` (None: empty) through
    ``ops.mlstm_chunk``; returns (y (B,S,D), final_state).

    Equal to the per-step recurrence up to rounding, whatever the chunk: the
    JAX package picks a chunk that divides S, the port masks its last chunk,
    so the two agree to rounding, not bit for bit.
    """
    q, k, v = (_proj(x, p[w]) for w in ("wq", "wk", "wv"))
    i_raw, log_f = _mlstm_gates(p, x)
    h, state = mlstm_chunk(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        i_raw.transpose(1, 2), log_f.transpose(1, 2), state, chunk=chunk,
    )
    h = rms_head_norm(h.transpose(1, 2), p["norm_w"])
    return _out(h, p["wo"]), state


def mlstm_decode(p, x1, state):
    """One-token recurrent step.  x1: (B,1,D)."""
    q, k, v = (_proj(x1, p[w])[:, 0] for w in ("wq", "wk", "wv"))
    i_raw, log_f = _mlstm_gates(p, x1)
    state, h = _mlstm_step(state, q, k, v, i_raw[:, 0], log_f[:, 0])
    h = rms_head_norm(h.to(x1.dtype), p["norm_w"])
    return _out(h[:, None], p["wo"]), state


# -------------------------------------------------------------------- slstm


def init_slstm(gen: torch.Generator, d_model: int, n_heads: int,
               head_dim: int, dtype, device=None, lead: tuple = ()):
    """The recurrent matrices, bias and head norm stay float32."""
    f32 = torch.float32
    return {
        # fused z,i,f,o input projections: (D, H, hd, 4)
        "w_in": _normal(gen, (*lead, d_model, n_heads, head_dim, 4),
                        d_model ** -0.5, dtype, device),
        # recurrent per-head projections (block-diagonal R): (H, hd, hd, 4)
        "r": _normal(gen, (*lead, n_heads, head_dim, head_dim, 4),
                     head_dim ** -0.5, f32, device),
        "b": torch.zeros((*lead, n_heads, head_dim, 4), dtype=f32,
                         device=device),
        "wo": _normal(gen, (*lead, n_heads, head_dim, d_model),
                      (n_heads * head_dim) ** -0.5, dtype, device),
        "norm_w": torch.ones((*lead, n_heads, head_dim), dtype=f32,
                             device=device),
    }


def slstm_init_state(p, batch: int):
    n_heads, hd = p["norm_w"].shape
    f32 = dict(dtype=torch.float32, device=p["norm_w"].device)
    return (torch.zeros((batch, n_heads, hd), **f32),
            torch.zeros((batch, n_heads, hd), **f32),
            torch.zeros((batch, n_heads, hd), **f32),
            torch.full((batch, n_heads, hd), -1e30, **f32))


def _slstm_step(p, carry, u_t):
    """u_t: (B,H,hd,4) pre-activations from the input projection."""
    c, n, h_prev, m = carry
    b, h, hd = h_prev.shape
    # JAX: einsum bhk,hkjg->bhjg, one batched product over the heads
    rec = (h_prev[:, :, None, :] @ p["r"].reshape(h, hd, -1)).reshape(
        b, h, hd, -1)
    pre = u_t + rec + p["b"]
    z = torch.tanh(pre[..., 0])
    i_raw = pre[..., 1]
    log_f = F.logsigmoid(pre[..., 2])                  # sigmoid forget
    o = torch.sigmoid(pre[..., 3])
    m_new = torch.maximum(log_f + m, i_raw)
    alpha = torch.exp(log_f + m - m_new)
    beta = torch.exp(i_raw - m_new)
    c = alpha * c + beta * z
    n = alpha * n + beta
    h = o * c / torch.clamp(n, min=1e-6)
    return (c, n, h, m_new), h


def slstm_forward(p, x, state=None):
    """x: (B,S,D) -> (y, state): the input projection of every token at
    once, then a loop over the recurrent step."""
    b, s, d = x.shape
    u = (x.float() @ p["w_in"].float().reshape(d, -1)).reshape(
        b, s, *p["w_in"].shape[1:])
    if state is None:
        state = slstm_init_state(p, b)
    hs = []
    for t in range(s):
        state, h_t = _slstm_step(p, state, u[:, t])
        hs.append(h_t)
    h = rms_head_norm(torch.stack(hs, dim=1).to(x.dtype), p["norm_w"])
    return _out(h, p["wo"]), state


def slstm_decode(p, x1, state):
    return slstm_forward(p, x1, state)
