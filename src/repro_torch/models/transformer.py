"""The dense-path Model of the port: PyTorch counterpart of
``repro.models.transformer``.

Same entry points, argument order and layouts as the JAX ``Model``:
parameters are a dict of layer-stacked ``(L, ...)`` tensors and caches
carry ``k``/``v`` of shape ``(L, B, T, n_kv, hd)`` plus the per-slot
position tensor ``kv_pos`` ``(L, B, T)`` (``-1`` = invalid).  Where JAX
returns a new cache, the port updates the caller's cache tensors in place
and returns the same dict.

Attention runs through the CUDA kernels where the JAX engine ran plain jnp:

* one-shot prefill (``dense_block_train``) calls ``flash_prefill``.  The
  JAX block's ``lens`` mask only hides keys that the causal mask already
  hides from the real rows; padded rows are thrown away by ``_gather_last``
  and masked by ``_fill_kv``, so the logits and the valid cache rows match;
* decode (``dense_block_decode``, full cache) calls ``paged_gqa_decode``
  over the slot cache viewed as pages of ``decode_page(T)`` tokens (16, or
  the largest divisor of T below it, so that any cache length views as
  whole pages), slot b's block table being ``b*T/bs + arange(T/bs)`` and
  its length ``pos + 1``.  That is exact while
  every slot's ``kv_pos`` row is ``j`` at each index ``j <= pos`` and -1 or
  beyond ``pos`` after it, which the engine keeps (``check_slot_contiguous``
  asserts it when ``Model(debug_checks=True)``);
* chunked prefill (``dense_block_chunk``, queries at an offset) stays on the
  plain ``attention_any``: no Pallas kernel computes it.

The ssm family (xLSTM) keeps the JAX layout too: ``params["xlstm_pairs"]``
holds pair-stacked ``(n_pairs, ...)`` mLSTM/sLSTM leaves and the cache holds
the recurrent state ``mlstm_c/n/m`` and ``slstm_c/n/h/m``, each
``(n_pairs, B, ...)`` float32.  Its prefill runs the chunkwise mLSTM through
the ``mlstm_chunk`` kernel (``models/ssm.py``); decode is the plain per-step
recurrence.

The dense and ssm families are served: MoE, VLM, encoder-decoder, hybrid
and ring (sliding-window smaller than the cache) layouts raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_prefill, paged_gqa_decode
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    AttnDims,
    attention_any,
    attention_out,
    attention_qkv,
    gated_mlp,
    init_attention,
    init_mlp,
    rms_norm,
)

#: tokens per page when decode attention views a slot cache as pages, for
#: every cache length that it divides (``decode_page``)
DECODE_PAGE = 16
#: prefill attention pads S to a multiple of this and uses it as the flash
#: kernel's block size (the engine's prompt bucket is 64 tokens)
PREFILL_BLOCK = 64
#: the ssm family's cache leaves, in the order the xLSTM blocks return them
#: (mLSTM C, n, m; sLSTM c, n, h, m)
SSM_STATE_KEYS = ("mlstm_c", "mlstm_n", "mlstm_m",
                  "slstm_c", "slstm_n", "slstm_h", "slstm_m")


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _unsupported(what: str, later: str):
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the {later} slice"
    )


def _check_family(cfg: ModelConfig) -> None:
    if cfg.kind == "moe" or cfg.is_moe:
        raise _unsupported("the MoE family", "MoE")
    if cfg.kind == "vlm":
        raise _unsupported("the VLM family", "VLM")
    if cfg.kind == "encdec":
        raise _unsupported("the encoder-decoder family", "other-families")
    if cfg.kind == "hybrid":
        raise _unsupported("the hybrid family", "other-families")
    if cfg.kind not in ("dense", "ssm"):
        raise ValueError(f"unknown kind {cfg.kind}")


def _write_rows(pos, t: int, s: int):
    """Row indices ``(B, S)`` of an S-row write at offsets ``pos`` into a
    T-row cache, clamped like ``jax.lax.dynamic_update_slice`` (the start
    moves so the whole slice fits)."""
    start = torch.clamp(pos.long(), 0, t - s)
    return start[:, None] + torch.arange(s, device=pos.device)


def update_cache(cache_kv, new_kv, pos):
    """cache_kv: (B,T,n,h); new_kv: (B,S,n,h); pos: (B,) write offsets.
    Writes in place and returns ``cache_kv``."""
    b, t = cache_kv.shape[:2]
    rows = _write_rows(pos, t, new_kv.shape[1])
    cache_kv[torch.arange(b, device=pos.device)[:, None], rows] = new_kv.to(
        cache_kv.dtype
    )
    return cache_kv


def update_pos(kv_pos, pos, s):
    """kv_pos: (B,T) slot-position tensor; write arange(pos, pos+s) in
    place."""
    b, t = kv_pos.shape
    new = pos.to(kv_pos.dtype)[:, None] + torch.arange(
        s, dtype=kv_pos.dtype, device=pos.device
    )
    kv_pos[torch.arange(b, device=pos.device)[:, None],
           _write_rows(pos, t, s)] = new
    return kv_pos


def update_pos_masked(kv_pos, pos, s, lens):
    """``update_pos`` with per-row valid lengths: positions at or beyond a
    row's true length are written as -1 (invalid slot), so padded chunk
    tails never become attendable cache entries."""
    b, t = kv_pos.shape
    new = pos.to(kv_pos.dtype)[:, None] + torch.arange(
        s, dtype=kv_pos.dtype, device=pos.device
    )
    new = torch.where(new < lens[:, None].to(kv_pos.dtype), new,
                      torch.full((), -1, dtype=kv_pos.dtype,
                                 device=pos.device))
    kv_pos[torch.arange(b, device=pos.device)[:, None],
           _write_rows(pos, t, s)] = new
    return kv_pos


def check_slot_contiguous(kv_pos, pos) -> None:
    """Raise unless every slot's ``kv_pos`` row is ``j`` at each index
    ``j <= pos`` and -1 or beyond ``pos`` after it: the precondition under
    which paged decode over a slot-contiguous block table equals the masked
    dense-cache attention.  ``kv_pos``: (B,T) or layer-stacked (L,B,T)."""
    t = kv_pos.shape[-1]
    j = torch.arange(t, device=kv_pos.device)
    p = pos.to(kv_pos.device).long()[:, None]
    head = (j[None] <= p)
    ok = torch.where(head, kv_pos == j, (kv_pos < 0) | (kv_pos > p))
    if not bool(ok.all()):
        bad = (~ok).reshape(-1, *ok.shape[-2:]).any(dim=(0, 2))
        slots = torch.nonzero(bad).flatten().tolist()
        raise RuntimeError(
            f"kv_pos rows of slots {slots} are not contiguous up to pos; "
            "paged decode over the slot cache would differ from the masked "
            "dense attention"
        )


def _prefill_attention(q, k, v, window: int):
    """Causal (+SWA) attention of a whole prompt through ``flash_prefill``:
    S is padded to a multiple of PREFILL_BLOCK (padded keys lie after every
    real query, so the causal mask hides them) and the padding cut off."""
    s = q.shape[1]
    pad = -s % PREFILL_BLOCK
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    out = flash_prefill(q, k, v, window=window, block_q=PREFILL_BLOCK,
                        block_k=PREFILL_BLOCK)
    return out[:, :s] if pad else out


def decode_page(t: int) -> int:
    """Tokens per page of a T-row slot cache's view: ``DECODE_PAGE`` where
    it divides T, else the largest divisor of T below it (10 at T 100, 1 at
    a prime T such as 97), so that the view holds whole pages at any cache
    length.  The paged kernel takes any page size."""
    return next(bs for bs in range(min(DECODE_PAGE, t), 0, -1)
                if t % bs == 0)


def slot_pages(b: int, t: int, pos):
    """The slot cache viewed as pages of ``bs = decode_page(T)`` tokens:
    slot b's block table ``b*T/bs + arange(T/bs)`` (B, T/bs) and lengths
    ``pos + 1`` (B,), both int32.  A decode step builds them once and hands
    them to every layer."""
    n_pages = t // decode_page(t)
    tables = torch.arange(b * n_pages, dtype=torch.int32,
                          device=pos.device).view(b, n_pages)
    return tables, (pos + 1).to(torch.int32)


def _decode_attention(q, k_cache, v_cache, pos, pages=None):
    """One query token per slot against the slot cache, through
    ``paged_gqa_decode`` with a slot-contiguous block table; ``pages`` is
    ``slot_pages(B, T, pos)`` where the caller has built it already."""
    b, t, n_kv, hd = k_cache.shape
    if pages is None:
        pages = slot_pages(b, t, pos)
    tables, lengths = pages
    bs = decode_page(t)
    out = paged_gqa_decode(
        q[:, 0],
        k_cache.view(b * (t // bs), bs, n_kv, hd),
        v_cache.view(b * (t // bs), bs, n_kv, hd),
        tables, lengths, block_size=bs,
    )
    return out[:, None]


# ===========================================================================
# dense decoder blocks
# ===========================================================================


def init_dense_blocks(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    """The layer-stacked block parameters (JAX: ``vmap(init_dense_block)``)."""
    lead = (cfg.n_layers,)
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    ones = torch.ones((*lead, cfg.d_model), dtype=torch.float32,
                      device=device)
    return {
        "ln1": ones,
        "attn": init_attention(gen, cfg.d_model, dims, dtype, device, lead),
        "ln2": ones.clone(),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, lead),
    }


def dense_block_train(p, x, positions, cfg: ModelConfig, attn_mask_lens=None):
    """Full-sequence causal block (prefill compute).

    Returns (x, (k, v, moe_aux)) so prefill can collect the cache.
    ``positions`` must be ``arange(S)`` per row, as every caller passes;
    ``attn_mask_lens`` is accepted for the JAX signature and needs no mask
    (see the module doc).
    """
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attention_qkv(p["attn"], h, positions, cfg.rope_theta,
                            cfg.use_rope)
    att = _prefill_attention(q, k, v, cfg.sliding_window)
    x = x + attention_out(p["attn"], att)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h2), (k, v, 0.0)


def dense_block_chunk(p, x, pos, positions, lens, k_cache, v_cache, kv_pos,
                      cfg: ModelConfig):
    """S-token chunk step against a (non-ring) KV cache: chunk K/V is
    written into the cache first (in place), then the queries attend over
    the whole cache masked by ``kv_pos``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = attention_qkv(
        p["attn"], h, positions, cfg.rope_theta, cfg.use_rope
    )
    update_cache(k_cache, k_new, pos)
    update_cache(v_cache, v_new, pos)
    update_pos_masked(kv_pos, pos, x.shape[1], lens)
    att = attention_any(
        q, k_cache, v_cache,
        window=cfg.sliding_window,
        q_positions=positions,
        kv_positions=kv_pos,
        kv_valid=kv_pos >= 0,
    )
    x = x + attention_out(p["attn"], att)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h2), k_cache, v_cache, kv_pos


def dense_block_decode(p, x, pos, k_cache, v_cache, kv_pos, cfg: ModelConfig,
                       ring: bool, pages=None):
    """One-token decode step against a full KV cache (updated in place).
    ``pages``: the step's ``slot_pages``, built here when not given."""
    if ring:
        raise _unsupported("the ring (sliding-window) cache", "ring-cache")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = attention_qkv(
        p["attn"], h, pos[:, None], cfg.rope_theta, cfg.use_rope
    )
    update_cache(k_cache, k_new, pos)
    update_cache(v_cache, v_new, pos)
    update_pos(kv_pos, pos, 1)
    att = _decode_attention(q, k_cache, v_cache, pos, pages)
    x = x + attention_out(p["attn"], att)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h2), k_cache, v_cache, kv_pos


# ===========================================================================
# xLSTM pairs (the ssm family)
# ===========================================================================


def init_xlstm_pairs(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    """The pair-stacked mLSTM/sLSTM parameters (JAX:
    ``vmap(_init_xlstm_pair)``); norms, gates and recurrent matrices stay
    float32."""
    lead = (cfg.n_layers // cfg.slstm_every,)
    ones = torch.ones((*lead, cfg.d_model), dtype=torch.float32,
                      device=device)
    dims = (cfg.d_model, cfg.n_heads, cfg.head_dim, dtype, device, lead)
    return {
        "ln_m": ones,
        "mlstm": ssm.init_mlstm(gen, *dims),
        "ln_s": ones.clone(),
        "slstm": ssm.init_slstm(gen, *dims),
    }


def xlstm_pair(lp, x, cfg: ModelConfig, m_state, s_state, *, decode: bool):
    """rms_norm -> mLSTM -> residual -> rms_norm -> sLSTM -> residual.
    Returns (x, the pair's seven state tensors in ``SSM_STATE_KEYS`` order)."""
    hm = rms_norm(x, lp["ln_m"], cfg.norm_eps)
    if decode:
        y, m_state = ssm.mlstm_decode(lp["mlstm"], hm, m_state)
    else:
        y, m_state = ssm.mlstm_forward_chunked(lp["mlstm"], hm, m_state)
    x = x + y
    hs = rms_norm(x, lp["ln_s"], cfg.norm_eps)
    slstm = ssm.slstm_decode if decode else ssm.slstm_forward
    y2, s_state = slstm(lp["slstm"], hs, s_state)
    return x + y2, (*m_state, *s_state)


def _gather_last(x, lens):
    """x: (B,S,D); lens: (B,) true lengths -> (B,1,D) at position lens-1."""
    b = x.shape[0]
    idx = torch.clamp(lens.long() - 1, 0, x.shape[1] - 1)
    return x[torch.arange(b, device=x.device), idx][:, None, :]


# ===========================================================================
# the Model
# ===========================================================================


class Model:
    """Serving entry points of the dense and ssm families on one device.

    ``device=None`` means ``cuda`` and raises when there is none; tests pass
    ``device="cpu"``.  ``debug_checks=True`` asserts the slot-contiguity
    precondition of paged decode after every dense decode step.
    """

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 *, debug_checks: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.debug_checks = bool(debug_checks)
        self._views: tuple[Any, list] = (None, [])

    # ------------------------------------------------------------ init

    def init(self, seed: int = 0) -> dict:
        """Seeded random parameters (a ``torch.Generator`` on the model's
        device; not JAX's numbers — parity tests bridge JAX's instead)."""
        cfg = self.cfg
        _check_family(cfg)
        dtype, dev = _dtype(cfg), self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params: dict[str, Any] = {
            "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                  device=dev) * 0.02).to(dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = (
                torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                            device=dev) * cfg.d_model ** -0.5
            ).to(dtype)
        if not cfg.use_rope:
            params["pos_emb"] = (
                torch.randn((cfg.max_position, cfg.d_model), generator=gen,
                            device=dev) * 0.02
            ).to(dtype)
        if cfg.kind == "ssm":
            params["xlstm_pairs"] = init_xlstm_pairs(gen, cfg, dtype, dev)
        else:
            params["blocks"] = init_dense_blocks(gen, cfg, dtype, dev)
        return params

    def layer_params(self, params) -> list:
        """Per-layer views of the stacked ``params["blocks"]`` (per-pair
        views of ``params["xlstm_pairs"]`` for ssm), kept while the same
        parameter dict is passed in."""
        cfg = self.cfg
        if cfg.kind == "ssm":
            stack, n = params["xlstm_pairs"], cfg.n_layers // cfg.slstm_every
        else:
            stack, n = params["blocks"], cfg.n_layers
        # read once: a replicated fleet serves one model from several
        # threads, and the pair is replaced whole, never mutated
        views = self._views
        if views[0] is not stack:
            def index(tree, l):
                if isinstance(tree, dict):
                    return {k: index(v, l) for k, v in tree.items()}
                return tree[l]

            views = (stack, [index(stack, l) for l in range(n)])
            self._views = views
        return views[1]

    # ------------------------------------------------------------ embed

    def _embed(self, params, tokens, positions):
        x = params["embed"][tokens.long()]
        if not self.cfg.use_rope:
            x = x + params["pos_emb"][positions.long()]
        return x

    def head_matrix(self, params):
        return (
            params["embed"].T if self.cfg.tie_embeddings
            else params["lm_head"]
        )

    def _logits(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x @ self.head_matrix(params)

    # ------------------------------------------------------------ serve

    def init_cache(self, params, batch: int, cache_len: int) -> dict:
        """Allocate an empty decode cache (kv_pos = -1 -> invalid)."""
        cfg = self.cfg
        _check_family(cfg)
        dev = self.device
        if cfg.kind == "ssm":
            n_pairs = cfg.n_layers // cfg.slstm_every
            nh, hd = cfg.n_heads, cfg.head_dim
            f32 = dict(dtype=torch.float32, device=dev)

            def z(*shape):
                return torch.zeros((n_pairs, batch, *shape), **f32)

            return {
                "mlstm_c": z(nh, hd, hd), "mlstm_n": z(nh, hd),
                "mlstm_m": torch.full((n_pairs, batch, nh), -1e30, **f32),
                "slstm_c": z(nh, hd), "slstm_n": z(nh, hd),
                "slstm_h": z(nh, hd),
                "slstm_m": torch.full((n_pairs, batch, nh, hd), -1e30,
                                      **f32),
            }
        t = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
             else cache_len)
        shape = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "kv_pos": torch.full(shape[:3], -1, dtype=torch.int32,
                                 device=dev),
        }

    def prefill(self, params, batch: dict, cache_len: int):
        """Process the full prompt; returns (last-position logits, cache).

        batch: {"tokens": (B,S), optional "lens": (B,)}.
        """
        cfg = self.cfg
        _check_family(cfg)
        if "embeds" in batch:
            raise _unsupported("prefill with embeddings", "VLM")
        tokens = batch["tokens"]
        b, s = tokens.shape
        dev = tokens.device
        lens = batch.get("lens")
        if lens is None:
            lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        cache = self.init_cache(params, b, cache_len)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        x = self._embed(params, tokens, positions)
        if cfg.kind == "ssm":
            # every row runs its whole S tokens (the engine prefills ssm
            # prompts one at a time at their exact length)
            for l, lp in enumerate(self.layer_params(params)):
                x, states = xlstm_pair(lp, x, cfg, None, None, decode=False)
                for key, st in zip(SSM_STATE_KEYS, states):
                    cache[key][l] = st
            return self._logits(params, _gather_last(x, lens)), cache
        ks, vs = [], []
        for lp in self.layer_params(params):
            x, (k, v, _) = dense_block_train(lp, x, positions, cfg,
                                             attn_mask_lens=lens)
            ks.append(k)
            vs.append(v)
        cache = self._fill_kv(cache, ks, vs, lens, s)
        logits = self._logits(params, _gather_last(x, lens))
        return logits, cache

    def prefill_chunked(self, params, batch: dict, cache_len: int,
                        chunk: int):
        """Chunked prefill: process the prompt ``chunk`` tokens at a time.

        Falls back to the one-shot :meth:`prefill` under exactly the JAX
        package's rules: prompts that fit in one chunk, non-dense/vlm
        families, VLM image batches, and ring caches smaller than the
        cache length.
        """
        cfg = self.cfg
        s = batch["tokens"].shape[1]
        ring = bool(cfg.sliding_window) and min(
            cache_len, cfg.sliding_window
        ) < cache_len
        if (
            s <= chunk
            or cfg.kind not in ("dense", "vlm")
            or "embeds" in batch
            or ring
        ):
            return self.prefill(params, batch, cache_len=cache_len)
        _check_family(cfg)

        tokens = batch["tokens"]
        b = tokens.shape[0]
        dev = tokens.device
        lens = batch.get("lens")
        if lens is None:
            lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        cache = self.init_cache(params, b, cache_len)
        layers = self.layer_params(params)
        hidden = []
        for c0 in range(0, s, chunk):
            toks_c = tokens[:, c0:c0 + chunk]
            sc = toks_c.shape[1]
            positions = torch.arange(c0, c0 + sc, device=dev)[None].expand(
                b, sc
            )
            pos0 = torch.full((b,), c0, dtype=torch.int32, device=dev)
            x = self._embed(params, toks_c, positions)
            for l, lp in enumerate(layers):
                x, _, _, _ = dense_block_chunk(
                    lp, x, pos0, positions, lens, cache["k"][l],
                    cache["v"][l], cache["kv_pos"][l], cfg,
                )
            hidden.append(x)
        x = torch.cat(hidden, dim=1)
        logits = self._logits(params, _gather_last(x, lens))
        return logits, cache

    def _fill_kv(self, cache, ks, vs, lens, s):
        """Copy prefill K/V (per layer (B,S,n,h)) into the cache's first S
        slots; kv_pos = arange(S) masked to -1 past each row's length."""
        t = cache["k"].shape[2]
        if s > t:
            raise _unsupported("a prompt longer than the (ring) cache",
                               "ring-cache")
        for l, (k, v) in enumerate(zip(ks, vs)):
            cache["k"][l, :, :s] = k
            cache["v"][l, :, :s] = v
        kvp = torch.arange(s, dtype=torch.int32, device=lens.device)[None]
        kvp = torch.where(kvp < lens[:, None], kvp,
                          torch.full((), -1, dtype=torch.int32,
                                     device=lens.device))
        cache["kv_pos"][:, :, :s] = kvp
        return cache

    def decode(self, params, cache: dict, tokens, pos):
        """One decode step.  tokens: (B,1) int; pos: (B,) positions of the
        new token.  Returns (logits (B,1,V), cache updated in place)."""
        cfg = self.cfg
        _check_family(cfg)
        x = self._embed(params, tokens, pos[:, None])
        if cfg.kind == "ssm":
            for l, lp in enumerate(self.layer_params(params)):
                old = [cache[key][l] for key in SSM_STATE_KEYS]
                x, states = xlstm_pair(lp, x, cfg, tuple(old[:3]),
                                       tuple(old[3:]), decode=True)
                for dst, st in zip(old, states):
                    dst.copy_(st)
            return self._logits(params, x), cache
        ring = bool(cfg.sliding_window) and (
            cache["k"].shape[2] == cfg.sliding_window
        )
        # one page table for every layer of the step
        b, t = cache["k"].shape[1:3]
        pages = None if ring else slot_pages(b, t, pos)
        for l, lp in enumerate(self.layer_params(params)):
            x, _, _, _ = dense_block_decode(
                lp, x, pos, cache["k"][l], cache["v"][l],
                cache["kv_pos"][l], cfg, ring, pages,
            )
        if self.debug_checks:
            check_slot_contiguous(cache["kv_pos"], pos)
        return self._logits(params, x), cache
