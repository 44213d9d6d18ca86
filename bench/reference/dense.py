"""The plain reference of the dense GQA decoder (Llama's and Mistral's
block: RMSNorm, rotary embeddings in the rotate-half layout, grouped-query
causal attention with an optional sliding window, a SiLU-gated MLP), in
float32 with TF32 off, over one whole sequence at a time.

Written from the published description, with no cache, batching or
kernel; it imports nothing of the program.  Each layer's weights are
widened to float32 as the layer runs, so a full-width model needs no
float32 copy of its weights.

``precision="fp8"`` is the control: every product with a weight matrix
takes its input rounded to float8 e4m3 with a scale per token and its
weight rounded to e4m3 with a scale per output column, the step below
the bfloat16 that the configurations state.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "fp8")
E4M3_MAX = 448.0


def _fp8(x, dim: int):
    """x rounded to float8 e4m3, scaled so that each slice along ``dim``
    spans the format, and widened back to float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _linear(x, w, precision: str):
    """x (..., k) @ w (k, n) in float32, or with fp8-rounded operands."""
    w = w.float()
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, positions, theta: float):
    """x (S, n, hd): rotate the first half of hd against the second."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, window: int):
    """Causal GQA over one sequence: q (S, nh, hd), k/v (S, n_kv, hd)."""
    s, nh, hd = q.shape
    qpk = nh // k.shape[1]
    k = k.repeat_interleave(qpk, dim=1)
    v = v.repeat_interleave(qpk, dim=1)
    scores = torch.einsum("qnh,knh->nqk", q, k) * hd ** -0.5
    i = torch.arange(s, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("nqk,knh->qnh", torch.softmax(scores, dim=-1), v)


@torch.no_grad()
def logits(cfg: dict, params: dict, tokens, first: int = 0,
           precision: str = "f32"):
    """Float32 logits (S - first, V) at positions ``first..S-1`` of the
    sequence ``tokens`` (S,)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{PRECISIONS}")
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(cfg, params, tokens, first, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _logits(cfg, params, tokens, first, precision):
    d = int(cfg["hidden_size"])
    nh, n_kv = int(cfg["num_attention_heads"]), int(
        cfg["num_key_value_heads"])
    hd = d // nh
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])
    window = int(cfg.get("sliding_window") or 0)
    tokens = tokens.long()
    s = tokens.shape[0]
    positions = torch.arange(s, device=tokens.device)
    x = params["embed"][tokens].float()
    blocks = params["blocks"]
    for l in range(int(cfg["num_hidden_layers"])):
        att, mlp = blocks["attn"], blocks["mlp"]
        h = _rms_norm(x, blocks["ln1"][l], eps)
        q = _linear(h, att["wq"][l].reshape(d, nh * hd), precision)
        k = _linear(h, att["wk"][l].reshape(d, n_kv * hd), precision)
        v = _linear(h, att["wv"][l].reshape(d, n_kv * hd), precision)
        q = _rope(q.view(s, nh, hd), positions, theta)
        k = _rope(k.view(s, n_kv, hd), positions, theta)
        o = _attention(q, k, v.view(s, n_kv, hd), window)
        x = x + _linear(o.reshape(s, nh * hd),
                        att["wo"][l].reshape(nh * hd, d), precision)
        h = _rms_norm(x, blocks["ln2"][l], eps)
        g = torch.nn.functional.silu(_linear(h, mlp["w1"][l], precision))
        x = x + _linear(g * _linear(h, mlp["w3"][l], precision),
                        mlp["w2"][l], precision)
    x = _rms_norm(x[first:], params["final_norm"], eps)
    head = (params["embed"].T if cfg.get("tie_word_embeddings")
            else params["lm_head"])
    return _linear(x, head, precision)
