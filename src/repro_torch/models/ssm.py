"""State-space and recurrent sequence mixers of the port: Mamba2 (SSD) and
the xLSTM's mLSTM and sLSTM blocks.

PyTorch counterparts of ``repro.models.ssm``, with the same names,
argument order, parameter keys and state layouts (per layer):

  mamba2:  h: (B, H, P, N)  conv: (B, W-1, d_inner + 2N)
  mlstm:   C: (B, H, hd, hd)  n: (B, H, hd)  m: (B, H)
  slstm:   c, n, h: (B, H, hd)  m: (B, H, hd)

Mamba2 is plain PyTorch, as no Pallas kernel computes it: the chunkwise
SSD form (``mamba2_forward_chunked``) for prefill, and the per-step
recurrence (``mamba2_forward``, its oracle) for decode.  Its state stays
float32; y is cast to x's dtype before the gated RMSNorm, as in JAX.

The chunkwise mLSTM of prefill runs through ``ops.mlstm_chunk``: the CUDA
kernel on the card, its plain version on the CPU.  Training runs the plain
chunkwise mLSTM (``mlstm_forward_train``, ``ref.mlstm_chunk_ref``) on every
device, as the JAX package trains on its jnp form: the kernel has no
backward.  The projections and gates around it are plain matrix products,
as the JAX package leaves them to XLA.  The per-step forms (``mlstm_forward``, ``mlstm_decode``) and the
whole sLSTM are plain PyTorch: no Pallas kernel computes them.
``slstm_forward`` projects the whole input once and then loops over the
recurrent step token by token, as the JAX ``lax.scan`` does.

Under a sharded plan (DTensor inputs) each mixer runs on the batch shards
of its input with its weights gathered whole (``_on_batch_shards``), and
its output is annotated as the JAX package annotates it.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ops import mlstm_chunk
from repro_torch.launch.op_analysis import expand, loop_weights, repeated
from repro_torch.kernels.ref import empty_mlstm_state, mlstm_chunk_ref
from repro_torch.models.layers import stacked_normal
from repro_torch.models.shardlib import local_call, shard

#: tokens per chunk of the chunkwise mLSTM (the kernel's largest tile); any
#: prompt length runs, the last chunk masked
MLSTM_CHUNK = 64


def _on_batch_shards(fn, p, x, state, state_sigs: tuple):
    """``fn(p, x, state) -> (y, new_state)`` on the batch shards of the
    DTensor ``x`` (and of the state tensors, whose dims ``state_sigs``
    name), with every weight of ``p`` gathered.  ``state`` is a tuple of
    tensors, or None (then ``fn`` gets None)."""
    st = tuple(state) if state is not None else (None,) * len(state_sigs)

    def flat(p, x, *st):
        y, new = fn(p, x, None if st[0] is None else tuple(st))
        return (y, *new)

    sigs = ",".join(state_sigs)
    y, *new = local_call(flat, f"~,bsd,{sigs}->bsd,{sigs}", p, x, *st,
                         keep="b")
    return shard(y, "batch", "seq", "embed"), tuple(new)


_MAMBA_STATE = ("bhpn", "bwc")
_MLSTM_STATE = ("bhkv", "bhk", "bh")
_SLSTM_STATE = ("bhk",) * 4


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


# ------------------------------------------------------------------- mamba2


def mamba2_dims(d_model: int, d_state: int):
    d_inner = 2 * d_model
    p = 64                       # head dim (Mamba2 default)
    h = d_inner // p             # ssm heads
    return d_inner, p, h, d_state


def init_mamba2(gen: torch.Generator, d_model: int, d_state: int,
                conv_width: int, dtype, device=None, lead: tuple = ()):
    """``lead``: leading shape of the leaves, e.g. ``(n_super,
    attn_every)`` for the hybrid's nested stack (drawn one layer at a
    time).  The decay logs, step biases, skip and norm scales stay
    float32, as in the JAX package."""
    d_inner, _, h, n = mamba2_dims(d_model, d_state)
    ch = d_inner + 2 * n
    f32 = dict(dtype=torch.float32, device=device)

    def per_head(v):
        return v.expand(*lead, *v.shape).clone()

    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": stacked_normal(gen, lead, (d_model, 2 * d_inner + 2 * n + h),
                               d_model ** -0.5, dtype, device),
        "conv_w": stacked_normal(gen, lead, (conv_width, ch), 0.1, dtype,
                                 device),
        "conv_b": torch.zeros((*lead, ch), dtype=dtype, device=device),
        "a_log": per_head(torch.log(torch.linspace(1.0, 16.0, h, **f32))),
        "dt_bias": torch.zeros((*lead, h), **f32),
        "d_skip": torch.ones((*lead, h), **f32),
        "w_out": stacked_normal(gen, lead, (d_inner, d_model),
                                d_inner ** -0.5, dtype, device),
        "norm_w": torch.ones((*lead, d_inner), **f32),
    }


def _mamba2_project(p, x, conv_state=None):
    """Shared projection+conv for prefill and decode.

    x: (B, S, D).  Returns z, xs, bv, cv, dt and the new conv state (the
    last W-1 rows of the conv input, padding rows included)."""
    b, s, d_model = x.shape
    d_inner = 2 * d_model
    h = p["a_log"].shape[0]
    n = (p["w_in"].shape[1] - 2 * d_inner - h) // 2

    zxbc = x @ p["w_in"]
    z = zxbc[..., :d_inner]
    xbc = zxbc[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbc[..., -h:]

    w = p["conv_w"].shape[0]
    if conv_state is None:
        conv_state = torch.zeros((b, w - 1, xbc.shape[-1]), dtype=xbc.dtype,
                                 device=x.device)
    xbc_pad = torch.cat([conv_state, xbc], dim=1)
    new_conv_state = xbc_pad[:, -(w - 1):]
    # causal depthwise conv via stacked shifts (w is small, 4)
    conv = sum(xbc_pad[:, i:i + s] * p["conv_w"][i]
               for i in range(w)) + p["conv_b"]
    conv = F.silu(conv)
    return (z, conv[..., :d_inner], conv[..., d_inner:d_inner + n],
            conv[..., d_inner + n:], dt, new_conv_state)


def _mamba2_steps(p, x, conv_state):
    """The projection, softplus step sizes ``dt`` and per-step log decays
    ``a * dt`` (B,S,H) float32, with xs as (B,S,H,P)."""
    b, s, d_model = x.shape
    h = p["a_log"].shape[0]
    z, xs, bv, cv, dt, new_conv = _mamba2_project(p, x, conv_state)
    xs = xs.reshape(b, s, h, (2 * d_model) // h)
    dt = F.softplus(dt.float() + p["dt_bias"])
    return z, xs, bv, cv, dt, -torch.exp(p["a_log"]) * dt, new_conv


def _mamba2_out(p, x, y, xs, z):
    """Skip term, the cast of y to x's dtype, the gated RMSNorm (Mamba2
    style, float32) and the output projection.  y: (B,S,H,P) float32."""
    b, s = x.shape[:2]
    y = y + xs.float() * p["d_skip"][..., None]
    y = y.reshape(b, s, -1).to(x.dtype)
    y32 = y.float() * F.silu(z.float())
    y32 = y32 * torch.rsqrt(
        torch.mean(y32 * y32, dim=-1, keepdim=True) + 1e-5
    ) * p["norm_w"]
    return y32.to(x.dtype) @ p["w_out"]


def mamba2_forward(p, x, state=None, conv_state=None):
    """Per-step form (the oracle of the chunkwise form, and decode).
    x: (B,S,D) -> (y, (ssm_state, conv_state))."""
    if isinstance(x, DTensor):
        return _on_batch_shards(
            lambda p, x, st: mamba2_forward(p, x, *(st or (None, None))),
            p, x, (state, conv_state) if state is not None else None,
            _MAMBA_STATE)
    b, s, _ = x.shape
    z, xs, bv, cv, dt, log_lam, new_conv = _mamba2_steps(p, x, conv_state)
    if state is None:
        state = torch.zeros((b, *xs.shape[2:], bv.shape[-1]),
                            dtype=torch.float32, device=x.device)
    decay = torch.exp(log_lam)
    xf, bf, cf = xs.float(), bv.float(), cv.float()
    ys = []
    for t in range(s):
        # outer product update: h = dec*h + dt * x (x) B
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dt[:, t, :, None],
                           bf[:, t])
        state = state * decay[:, t, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    y = torch.stack(ys, dim=1)
    return _mamba2_out(p, x, y, xs, z), (state, new_conv)


def mamba2_forward_chunked(p, x, state=None, conv_state=None,
                           chunk: int = 512):
    """Chunkwise SSD form (Mamba2 paper §6): quadratic only within a
    chunk, the same math as the per-step recurrence.  Per head, with
    cum_t the running sum of the log decays a*dt_j (<= 0):

      y_t   = e^{cum_t} (C_t . H_0) + sum_{j<=t} e^{cum_t-cum_j} (C_t.B_j) u_j
      H_out = e^{cum_L} H_0 + sum_j e^{cum_L-cum_j} u_j (x) B_j

    The chunk size is JAX's rule: ``s // max(1, s // min(chunk, s))``,
    raised until it divides S."""
    if isinstance(x, DTensor):
        return _on_batch_shards(
            lambda p, x, st: mamba2_forward_chunked(
                p, x, *(st or (None, None)), chunk=chunk),
            p, x, (state, conv_state) if state is not None else None,
            _MAMBA_STATE)
    b, s, _ = x.shape
    z, xs, bv, cv, dt, log_lam, new_conv = _mamba2_steps(p, x, conv_state)
    h, pdim = xs.shape[2:]
    n = bv.shape[-1]
    if state is None:
        state = torch.zeros((b, h, pdim, n), dtype=torch.float32,
                            device=x.device)

    c = divisor_chunk(s, chunk)
    nc = s // c

    ug = (xs.float() * dt[..., None]).reshape(b, nc, c, h, pdim)
    bg = bv.float().reshape(b, nc, c, n)
    cg = cv.float().reshape(b, nc, c, n)
    lg = log_lam.reshape(b, nc, c, h)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    ys = []
    weights = loop_weights(nc, x)
    for i, w in enumerate(weights):
        with repeated(w):
            u_c, b_c, c_c = ug[:, i], bg[:, i], cg[:, i]
            cum = torch.cumsum(lg[:, i], dim=1)                       # (B,c,H)
            # intra-chunk decay-weighted "attention" (B,c,c,H): the exponent
            # is positive in the masked upper triangle, so it is zeroed before
            # the exp
            expo = cum[:, :, None, :] - cum[:, None, :, :]            # t, j
            ratio = torch.exp(torch.where(causal, expo, 0.0))
            cb = torch.einsum("btn,bjn->btj", c_c, b_c)
            g = torch.where(causal, cb[..., None] * ratio, 0.0)
            y_intra = torch.einsum("btjh,bjhp->bthp", g, u_c)
            y_inter = torch.exp(cum)[..., None] * torch.einsum(
                "btn,bhpn->bthp", c_c, state)
            # chunk-final state
            wj = torch.exp(cum[:, -1:, :] - cum)                      # (B,c,H)
            upd = torch.einsum("bjhp,bjn,bjh->bhpn", u_c, b_c, wj)
            state = state * torch.exp(cum[:, -1])[..., None, None] + upd
            ys.append(y_intra + y_inter)
    y = torch.cat(expand(ys, weights), dim=1)
    return _mamba2_out(p, x, y, xs, z), (state, new_conv)


def mamba2_decode(p, x1, state, conv_state):
    """One-token decode. x1: (B,1,D)."""
    return mamba2_forward(p, x1, state=state, conv_state=conv_state)


def mamba2_init_state(p, batch: int, d_model: int):
    h = p["a_log"].shape[0]
    pdim = (2 * d_model) // h
    n = (p["w_in"].shape[1] - 4 * d_model - h) // 2
    w = p["conv_w"].shape[0]
    dev = p["w_in"].device
    return (
        torch.zeros((batch, h, pdim, n), dtype=torch.float32, device=dev),
        torch.zeros((batch, w - 1, 2 * d_model + 2 * n),
                    dtype=p["conv_w"].dtype, device=dev),
    )


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


def divisor_chunk(s: int, chunk: int) -> int:
    """JAX's chunk rule: ``s // max(1, s // min(chunk, s))``, raised until
    it divides S."""
    c = s // max(1, s // min(chunk, s))
    while s % c:
        c += 1
    return c


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


def _mlstm_qkv(p, x):
    """q, k, v (B,S,H,hd), annotated as the JAX package annotates them
    (inside a batch-local region they are plain local tensors, and the
    annotations pass them through)."""
    q, k, v = (_proj(x, p[w]) for w in ("wq", "wk", "wv"))
    return (shard(q, "batch", "seq", "heads", "head_dim"),
            shard(k, "batch", "seq", "kv_heads", "head_dim"),
            shard(v, "batch", "seq", "kv_heads", "head_dim"))


def mlstm_forward(p, x, state=None):
    """Recurrent full-sequence form, one step per token (the oracle of the
    chunkwise form).  Returns (y (B,S,D), final_state)."""
    b, s, _ = x.shape
    q, k, v = _mlstm_qkv(p, x)
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


def _mlstm_chunked(p, x, state, chunk_fn):
    """Projections, gates, ``chunk_fn`` (the chunkwise mLSTM over
    (B, H, S, ...) tensors), head norm and output projection."""
    q, k, v = _mlstm_qkv(p, x)
    i_raw, log_f = _mlstm_gates(p, x)
    h, state = chunk_fn(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        i_raw.transpose(1, 2), log_f.transpose(1, 2), state,
    )
    h = rms_head_norm(h.transpose(1, 2), p["norm_w"])
    return _out(h, p["wo"]), state


def mlstm_forward_chunked(p, x, state=None, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM from ``state`` (None: empty) through
    ``ops.mlstm_chunk``; returns (y (B,S,D), final_state).

    Equal to the per-step recurrence up to rounding, whatever the chunk: the
    JAX package picks a chunk that divides S, the port masks its last chunk,
    so the two agree to rounding, not bit for bit.
    """
    if isinstance(x, DTensor):
        return _on_batch_shards(
            lambda p, x, st: mlstm_forward_chunked(p, x, st, chunk),
            p, x, state, _MLSTM_STATE)
    return _mlstm_chunked(p, x, state,
                          functools.partial(mlstm_chunk, chunk=chunk))


def mlstm_forward_train(p, x, chunk: int = 256):
    """The training form of the JAX package's ``mlstm_forward_chunked``:
    the plain chunkwise mLSTM (``mlstm_chunk_ref``, differentiable) from
    the empty state, in chunks of JAX's rule (``divisor_chunk``, 256 by
    default).  Returns (y (B,S,D), final_state)."""
    if isinstance(x, DTensor):
        return _on_batch_shards(
            lambda p, x, st: mlstm_forward_train(p, x, chunk), p, x, None,
            _MLSTM_STATE)
    c = divisor_chunk(x.shape[1], chunk)
    return _mlstm_chunked(p, x, None,
                          functools.partial(mlstm_chunk_ref, chunk=c))


def mlstm_decode(p, x1, state):
    """One-token recurrent step.  x1: (B,1,D)."""
    if isinstance(x1, DTensor):
        return _on_batch_shards(mlstm_decode, p, x1, state, _MLSTM_STATE)
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
    if isinstance(x, DTensor):
        return _on_batch_shards(slstm_forward, p, x, state, _SLSTM_STATE)
    b, s, d = x.shape
    u = (x.float() @ p["w_in"].float().reshape(d, -1)).reshape(
        b, s, *p["w_in"].shape[1:])
    if state is None:
        state = slstm_init_state(p, b)
    hs = []
    weights = loop_weights(s, x)
    for t, w in enumerate(weights):
        with repeated(w):
            state, h_t = _slstm_step(p, state, u[:, t])
        hs.append(h_t)
    h = rms_head_norm(torch.stack(expand(hs, weights), dim=1).to(x.dtype),
                      p["norm_w"])
    return _out(h, p["wo"]), state


def slstm_decode(p, x1, state):
    return slstm_forward(p, x1, state)
