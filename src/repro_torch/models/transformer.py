"""The Model of the port: PyTorch counterpart of
``repro.models.transformer``, every family of the JAX package.

Same entry points, argument order and layouts as the JAX ``Model``:
parameters are a dict of layer-stacked ``(L, ...)`` tensors and caches
carry ``k``/``v`` of shape ``(L, B, T, n_kv, hd)`` plus the per-slot
position tensor ``kv_pos`` ``(L, B, T)`` (``-1`` = invalid).  Where JAX
returns a new cache, the port updates the caller's cache tensors in place
and returns the same dict.

Attention runs through the kernels' wrappers (``kernels/ops.py``) where the
JAX engine ran plain jnp, except on ``meta`` tensors (the dry-run's plans),
where ``_prefill_attention``, ``_decode_attention`` and ``xlstm_pair`` run
JAX's plain composition; the kernels with no CPU branch at the block's
level run only on ``ops.plain_cuda`` tensors:

* one-shot prefill (``dense_block_prefill``) calls ``flash_prefill``.  The
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
  asserts it when ``Model(debug_checks=True)``).  On plain CUDA tensors the
  block's glue runs in the fused kernels too (``fused_decode_path``): the
  norms, RoPE with the cache writes, and SiLU-and-multiply;
* chunked prefill (``dense_block_chunk``, queries at an offset against
  the cache, masked by ``kv_pos``) calls ``chunk_attention`` where
  ``chunk_attention_path`` allows it: plain bf16 CUDA tensors at a head
  dim of the tensor-core kernels and a chunk of whole 64-row tiles.  The
  kernel computes the plain ``attention_any`` that JAX runs there (no
  Pallas kernel computes it), which the CPU, float32, the other head dims
  and a sharded plan's DTensors keep.  ``prefill_slice`` (one slot's slice
  against the live cache, the engine's fused prefill) stays on
  ``attention_any``, as in JAX;
* decode over a ring cache (a sliding window smaller than the cache
  length: ``T == window`` rows, decode position p at row ``p mod T``)
  stays on the plain ``gqa_attention`` with ``kv_pos``, the window and
  ``kv_valid``, as JAX computes it.  The ring's rows are not a
  slot-contiguous run of positions (``_fill_kv`` keeps a long prompt's
  last T tokens at rows 0..T-1, which a later wrap overwrites out of
  order, as in JAX), so the paged kernel, which ignores ``kv_pos``, does
  not compute it.

The MoE family shares the dense blocks with a GShard MoE
(``layers.moe_mlp``, plain PyTorch as in JAX) in place of the gated MLP;
its chunked prefill is always one-shot (per-chunk capacities would drop
other tokens), as the JAX package's ``prefill_chunked`` rules it.

The ssm family (xLSTM) keeps the JAX layout too: ``params["xlstm_pairs"]``
holds pair-stacked ``(n_pairs, ...)`` mLSTM/sLSTM leaves and the cache holds
the recurrent state ``mlstm_c/n/m`` and ``slstm_c/n/h/m``, each
``(n_pairs, B, ...)`` float32.  Its prefill runs the chunkwise mLSTM through
the ``mlstm_chunk`` kernel (``models/ssm.py``); decode is the plain per-step
recurrence.

The VLM family (llava-next-34b) is the dense decoder: ``prefill`` with
``batch["embeds"]`` prepends the image embeddings to the text's token
embeddings (no position embedding on the text rows), runs positions
``arange`` over image plus text, and counts the image in ``lens``, as
JAX's ``prefill`` does; without embeddings it is the dense path.

The hybrid family (zamba2) keeps JAX's nested layout:
``params["super_blocks"]`` holds ``(n_super, attn_every, ...)`` Mamba2
leaves and one ``shared_attn`` dense block is applied after each group,
each application with its own KV cache ``k``/``v`` ``(n_super, B, T, ...)``;
the cache also holds ``mamba_h`` ``(n_super, attn_every, B, H, P, N)``
float32 and ``mamba_conv`` ``(n_super, attn_every, B, W-1, d_inner+2N)``.
Mamba2 is plain PyTorch (``models/ssm.py``); the shared block's attention
runs flash in prefill and paged decode on a full cache.  As in JAX, a
ragged batch's padding rows run through the Mamba2 state, so the shared
block gives them JAX's masked attention too (``_padded_queries``).

The encoder-decoder family (whisper) runs the bidirectional encoder on the
plain ``gqa_attention`` (no Pallas kernel computes it), the decoder's
causal self-attention through flash in prefill and paged decode in decode
(``dense_block_decode_selfonly``), and cross-attention on the plain
attention over ``cross_k``/``cross_v`` ``(L, B, F, n_kv, hd)``, as JAX.

Training (``hidden``, ``forward``) runs no kernel: the JAX package trains
on its plain attention (``attention_any``) and its jnp chunkwise mLSTM, as
no Pallas kernel has a backward, and so does the port
(``dense_block_train``, ``ssm.mlstm_forward_train``).
The kernels' wrappers raise on the card where an input requires grad.
``jax.checkpoint`` (remat) becomes ``torch.utils.checkpoint`` without
reentrance.  The serving entry points run under ``torch.no_grad()``, as
JAX's serving computes no gradients.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.chunk_attention import chunk_path
from repro_torch.kernels.flash_attention import PREFILL_BLOCK
from repro_torch.kernels.ops import (
    chunk_attention,
    flash_prefill,
    fused_add_rms_norm,
    fused_rms_norm,
    paged_gqa_decode,
    plain_cuda,
    rope_kv_write,
    silu_mul,
)
from repro_torch.kernels.ref import put_rows, write_rows
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    AttnDims,
    attention_any,
    attention_out,
    attention_qkv,
    gated_mlp,
    gqa_attention,
    init_attention,
    init_mlp,
    init_moe,
    matmul,
    moe_mlp,
    project_heads,
    rms_norm,
    rope_tables,
)
from repro_torch.models.shardlib import (
    contiguous_stride,
    local_call,
    local_offset,
    shard,
)

#: tokens per page when decode attention views a slot cache as pages, for
#: every cache length that it divides (``decode_page``)
DECODE_PAGE = 16
#: the ssm family's cache leaves, in the order the xLSTM blocks return them
#: (mLSTM C, n, m; sLSTM c, n, h, m)
SSM_STATE_KEYS = ("mlstm_c", "mlstm_n", "mlstm_m",
                  "slstm_c", "slstm_n", "slstm_h", "slstm_m")


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


#: the families of the JAX ``Model``, every one ported
KINDS = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown kind {cfg.kind}")


def _scatter_rows(cache, new, rows):
    """``cache[b, rows[b, i]] = new[b, i]`` in place on a DTensor cache
    (B, T, ...), on each rank's own shard: ``new`` and ``rows`` are brought
    to the cache's layout (never the cache to theirs), and a rank whose
    shard of a sequence-sharded cache does not hold a row writes it back
    unchanged (the ring write at ``pos mod T`` of the JAX package's
    long-context decode lands on the one shard that owns the row)."""
    mesh, pl = cache.device_mesh, cache.placements

    def as_dt(x):
        if isinstance(x, DTensor):
            return x
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    new_pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
              for p in pl]
    rows_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in pl]
    new = as_dt(new).redistribute(mesh, new_pl).to_local()
    rows = as_dt(rows).redistribute(mesh, rows_pl).to_local()
    local = cache.to_local()
    t_local = local.shape[1]
    lr = rows.long() - local_offset(cache, 1)
    own = (lr >= 0) & (lr < t_local)
    lr = torch.clamp(lr, 0, t_local - 1)
    bi = torch.arange(local.shape[0], device=lr.device)[:, None]
    own = own.reshape(*own.shape, *(1,) * (local.ndim - 2))
    local[bi, lr] = torch.where(own, new.to(local.dtype), local[bi, lr])
    return cache


def update_cache(cache_kv, new_kv, pos):
    """cache_kv: (B,T,n,h); new_kv: (B,S,n,h); pos: (B,) write offsets.
    Writes in place and returns ``cache_kv``."""
    rows = write_rows(pos, cache_kv.shape[1], new_kv.shape[1])
    if isinstance(cache_kv, DTensor):
        return _scatter_rows(cache_kv, new_kv, rows)
    return put_rows(cache_kv, rows, new_kv)


def update_pos(kv_pos, pos, s):
    """kv_pos: (B,T) slot-position tensor; write arange(pos, pos+s) in
    place."""
    new = pos.to(kv_pos.dtype)[:, None] + torch.arange(
        s, dtype=kv_pos.dtype, device=pos.device
    )
    rows = write_rows(pos, kv_pos.shape[1], s)
    if isinstance(kv_pos, DTensor):
        return _scatter_rows(kv_pos, new, rows)
    return put_rows(kv_pos, rows, new)


def update_pos_masked(kv_pos, pos, s, lens):
    """``update_pos`` with per-row valid lengths: positions at or beyond a
    row's true length are written as -1 (invalid slot), so padded chunk
    tails never become attendable cache entries."""
    new = pos.to(kv_pos.dtype)[:, None] + torch.arange(
        s, dtype=kv_pos.dtype, device=pos.device
    )
    new = torch.where(new < lens[:, None].to(kv_pos.dtype), new,
                      torch.full((), -1, dtype=kv_pos.dtype,
                                 device=pos.device))
    rows = write_rows(pos, kv_pos.shape[1], s)
    if isinstance(kv_pos, DTensor):
        return _scatter_rows(kv_pos, new, rows)
    return put_rows(kv_pos, rows, new)


def ring_update_cache(cache_kv, new_kv, pos):
    """SWA ring buffer: write one token at row ``pos % T`` (in place).
    new_kv: (B,1,n,h)."""
    b, t = cache_kv.shape[:2]
    if isinstance(cache_kv, DTensor):
        return _scatter_rows(cache_kv, new_kv, (pos.long() % t)[:, None])
    rows = torch.arange(b, device=pos.device)
    cache_kv[rows, pos.long() % t] = new_kv[:, 0].to(cache_kv.dtype)
    return cache_kv


def ring_update_pos(kv_pos, pos):
    """Record position ``pos`` at ring row ``pos % T`` (in place)."""
    b, t = kv_pos.shape
    if isinstance(kv_pos, DTensor):
        return _scatter_rows(kv_pos, pos.to(kv_pos.dtype)[:, None],
                             (pos.long() % t)[:, None])
    rows = torch.arange(b, device=pos.device)
    kv_pos[rows, pos.long() % t] = pos.to(kv_pos.dtype)
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


def _plain_attention(q, k, v, positions, lens, window: int):
    """JAX's attention of a whole sequence: ``attention_any`` with the keys
    at or past each row's ``lens`` masked (``None``: none), differentiable
    on every device."""
    kv_valid = None
    if lens is not None:
        kv_valid = (torch.arange(q.shape[1], device=q.device)[None, :]
                    < lens[:, None])
    return attention_any(q, k, v, window=window, q_positions=positions,
                         kv_positions=positions, kv_valid=kv_valid)


def _prefill_attention(q, k, v, positions, lens, window: int,
                       padded_rows: bool = False):
    """Causal (+SWA) attention of a whole prompt (``positions``
    ``arange(S)`` per row) through ``flash_prefill``: S is padded to a
    multiple of PREFILL_BLOCK (padded keys lie after every real query, so
    the causal mask hides them) and the padding cut off; the real rows need
    no ``lens`` mask (see the module doc).  ``padded_rows=True`` also makes
    the padded rows JAX's (``_padded_queries``).  DTensors are
    redistributed to shards holding whole heads (split on the heads where
    ``n_heads`` and ``n_kv`` both divide the mesh axis, else replicated) and
    the kernel runs on those.  On ``meta`` tensors it is JAX's
    ``_plain_attention``."""
    if q.is_meta:
        return _plain_attention(q, k, v, positions, lens, window)
    att = local_call(functools.partial(_prefill_attention_local,
                                       window=window),
                     "bsnh,bsnh,bsnh->bsnh", q, k, v, keep="bn", split="n")
    return _padded_queries(q, k, v, att, lens, window) if padded_rows else att


def _prefill_attention_local(q, k, v, *, window: int):
    s = q.shape[1]
    pad = -s % PREFILL_BLOCK
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    out = flash_prefill(q, k, v, window=window)
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


def _decode_attention(q, k_cache, v_cache, pos, pages=None, kv_pos=None,
                      window: int = 0):
    """One query token per slot against the slot cache, through
    ``paged_gqa_decode`` with a slot-contiguous block table; ``pages`` is
    ``slot_pages(B, T, pos)`` where the caller has built it already.
    DTensors run on shards holding whole heads of whole sequences, as in
    ``_prefill_attention``, each building its own block tables.  On
    ``meta`` tensors it is JAX's masked attention over ``kv_pos`` and the
    ``window``."""
    if q.is_meta:
        return gqa_attention(q, k_cache, v_cache, window=window,
                             q_positions=pos[:, None], kv_positions=kv_pos,
                             kv_valid=kv_pos >= 0)
    if isinstance(k_cache, DTensor):
        return local_call(_decode_attention, "bsnh,btnh,btnh,b->bsnh", q,
                          k_cache, v_cache, pos, keep="bn", split="n")
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


def init_dense_blocks(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                      lead: Optional[tuple] = None):
    """The layer-stacked block parameters (JAX: ``vmap(init_dense_block)``):
    a ``moe`` leaf (router and ``(L, E, ...)`` experts) where the config
    has experts, else ``mlp``.  ``lead``: the stack's leading shape,
    ``(n_layers,)`` unless given (``()`` for the hybrid's one shared
    block); every weight is drawn one layer at a time."""
    if lead is None:
        lead = (cfg.n_layers,)
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    ones = torch.ones((*lead, cfg.d_model), dtype=torch.float32,
                      device=device)
    p = {
        "ln1": ones,
        "attn": init_attention(gen, cfg.d_model, dims, dtype, device, lead),
        "ln2": ones.clone(),
    }
    if cfg.is_moe:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype,
                            device, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, lead)
    return p


def block_ffn(p, x, cfg: ModelConfig):
    """The block's feed-forward: the MoE where the config has experts (its
    capacities over this call's whole S), else the gated MLP.  Returns
    ``(y, aux)``."""
    if cfg.is_moe:
        return moe_mlp(p["moe"], x, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor)
    return gated_mlp(p["mlp"], x), 0.0


def _padded_queries(q, k, v, att, lens, window: int):
    """Overwrite the flash output of each row's padded queries (positions
    at or past its length) with JAX's masked attention, which hides every
    padded key from them: they attend to the row's real keys only, where
    the causal flash kernel lets them see the padding before them.  One
    plain attention per ragged row (a host read of ``lens``)."""
    s = q.shape[1]
    idx = torch.arange(s, device=q.device)[None]
    for b, n in enumerate(lens.tolist()):
        if n < s:
            att[b:b + 1, n:] = gqa_attention(
                q[b:b + 1, n:], k[b:b + 1], v[b:b + 1], window=window,
                q_positions=idx[:, n:], kv_positions=idx, kv_valid=idx < n)
    return att


def _dense_block(p, x, positions, cfg: ModelConfig, attend):
    """The full-sequence causal block around ``attend(q, k, v)``.  Returns
    (x, (k, v, moe_aux)), so that prefill can collect the cache."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attention_qkv(p["attn"], h, positions, cfg.rope_theta,
                            cfg.use_rope)
    x = x + attention_out(p["attn"], attend(q, k, v))
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = block_ffn(p, h2, cfg)
    return x + y, (k, v, aux)


def dense_block_train(p, x, positions, cfg: ModelConfig):
    """Training's full-sequence block: JAX's ``_plain_attention``,
    differentiable on every device.  Returns (x, (k, v, moe_aux))."""
    return _dense_block(p, x, positions, cfg, lambda q, k, v: (
        _plain_attention(q, k, v, positions, None, cfg.sliding_window)))


def dense_block_prefill(p, x, positions, lens, cfg: ModelConfig,
                        padded_rows: bool = False):
    """Prefill's full-sequence block: ``_prefill_attention`` over rows of
    ``lens`` tokens (``padded_rows=True`` for the hybrid, whose padded rows
    run on through the Mamba2 state).  Returns (x, (k, v, moe_aux))."""
    return _dense_block(p, x, positions, cfg, lambda q, k, v: (
        _prefill_attention(q, k, v, positions, lens, cfg.sliding_window,
                           padded_rows)))


def dense_block_chunk(p, x, pos, positions, lens, k_cache, v_cache, kv_pos,
                      cfg: ModelConfig):
    """S-token chunk step against a (non-ring) KV cache: chunk K/V is
    written into the cache first (in place), then the queries attend over
    the whole cache masked by ``kv_pos``, through the ``chunk_attention``
    kernel where ``chunk_attention_path`` allows it."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = attention_qkv(
        p["attn"], h, positions, cfg.rope_theta, cfg.use_rope
    )
    update_cache(k_cache, k_new, pos)
    update_cache(v_cache, v_new, pos)
    update_pos_masked(kv_pos, pos, x.shape[1], lens)
    if chunk_attention_path(q, k_cache):
        att = chunk_attention(q, k_cache, v_cache, positions, kv_pos,
                              window=cfg.sliding_window)
    else:
        att = attention_any(
            q, k_cache, v_cache,
            window=cfg.sliding_window,
            q_positions=positions,
            kv_positions=kv_pos,
            kv_valid=kv_pos >= 0,
        )
    x = x + attention_out(p["attn"], att)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + block_ffn(p, h2, cfg)[0], k_cache, v_cache, kv_pos


def chunk_attention_path(q, k_cache) -> bool:
    """Whether a chunk step's attention runs the ``chunk_attention``
    kernel: ``plain_cuda`` tensors that ``chunk_path`` takes (bf16 q and
    cache, hd 32, 64, 80 or 128, a chunk of a multiple of 64 queries).  The
    CPU, float32, other head dims, ragged chunks and a sharded plan's
    DTensors keep ``attention_any``."""
    return (plain_cuda(q, k_cache) and k_cache.dtype == q.dtype
            and chunk_path(q.dtype, q.shape[-1], q.shape[1]))


def fused_decode_path(x, k_cache, cfg: ModelConfig, ring: bool) -> bool:
    """Whether a decode block runs its glue through the fused kernels
    (``_dense_block_decode_fused``): a full cache, rotary positions and
    ``plain_cuda`` tensors.  A ring, a sharded plan's DTensors, the CPU and
    ``meta`` keep the composed path."""
    return not ring and cfg.use_rope and plain_cuda(x, k_cache)


def _dense_block_decode_fused(p, x, pos, k_cache, v_cache, kv_pos,
                              cfg: ModelConfig, pages, rope):
    """``dense_block_decode`` on a full cache with its glue in four
    kernel calls: ``fused_rms_norm`` (``ln1``), ``rope_kv_write`` (RoPE of
    q and k, the K/V and ``kv_pos`` writes), ``fused_add_rms_norm`` (the
    attention's residual and ``ln2``) and ``silu_mul`` (the gated MLP; the
    MoE keeps ``moe_mlp``).  The same GEMMs and paged attention, each
    kernel rounding as the composition it replaces (``kernels/ref.py``).
    ``rope``: the step's ``rope_tables`` at ``pos[:, None]``."""
    attn = p["attn"]
    h = fused_rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = (project_heads(h, attn[w]) for w in ("wq", "wk", "wv"))
    q = rope_kv_write(q, k, v, *rope, pos, k_cache, v_cache, kv_pos)
    att = _decode_attention(q[:, None], k_cache, v_cache, pos, pages)
    x, h2 = fused_add_rms_norm(x, attention_out(attn, att), p["ln2"],
                               cfg.norm_eps)
    if cfg.is_moe:
        y = block_ffn(p, h2, cfg)[0]
    else:
        mlp = p["mlp"]
        y = matmul(silu_mul(matmul(h2, mlp["w1"], "bsd,df->bsf"),
                            matmul(h2, mlp["w3"], "bsd,df->bsf")),
                   mlp["w2"], "bsf,fd->bsd")
    return x + y, k_cache, v_cache, kv_pos


def dense_block_decode(p, x, pos, k_cache, v_cache, kv_pos, cfg: ModelConfig,
                       ring: bool, pages=None, rope=None):
    """One-token decode step against a (possibly ring) KV cache, updated in
    place.  A full cache decodes through ``_decode_attention`` (``pages``:
    the step's ``slot_pages``, built there when not given), on plain CUDA
    tensors with the fused glue (``fused_decode_path``; ``rope``: the
    step's ``rope_tables``, built here when not given, as ``Model.decode``
    builds them once for every layer), a ring through the plain masked
    attention (the JAX package's decode attention)."""
    if fused_decode_path(x, k_cache, cfg, ring):
        if rope is None:
            rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta,
                               x.device)
        return _dense_block_decode_fused(p, x, pos, k_cache, v_cache, kv_pos,
                                         cfg, pages, rope)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = attention_qkv(
        p["attn"], h, pos[:, None], cfg.rope_theta, cfg.use_rope
    )
    if ring:
        ring_update_cache(k_cache, k_new, pos)
        ring_update_cache(v_cache, v_new, pos)
        ring_update_pos(kv_pos, pos)
        att = gqa_attention(
            q, k_cache, v_cache,
            window=cfg.sliding_window,
            q_positions=pos[:, None],
            kv_positions=kv_pos,
            kv_valid=kv_pos >= 0,
        )
    else:
        update_cache(k_cache, k_new, pos)
        update_cache(v_cache, v_new, pos)
        update_pos(kv_pos, pos, 1)
        att = _decode_attention(q, k_cache, v_cache, pos, pages, kv_pos,
                                cfg.sliding_window)
    x = x + attention_out(p["attn"], att)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + block_ffn(p, h2, cfg)[0], k_cache, v_cache, kv_pos


# ===========================================================================
# encoder-decoder and hybrid blocks
# ===========================================================================


def init_decoder_blocks(gen: torch.Generator, cfg: ModelConfig, dtype,
                        device):
    """The encoder-decoder's layer-stacked decoder blocks (JAX:
    ``vmap(_init_decoder_block)``): the dense blocks' self-attention and
    gated MLP, plus cross-attention behind its own norm ``ln_x``."""
    p = init_dense_blocks(gen, cfg, dtype, device)
    p["ln_x"] = torch.ones_like(p["ln1"])
    p["xattn"] = init_attention(
        gen, cfg.d_model, AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        dtype, device, (cfg.n_layers,))
    return p


def dense_block_decode_selfonly(p, x, pos, k_cache, v_cache, kv_pos,
                                cfg: ModelConfig, pages=None):
    """Self-attention part of a decoder block (cross-attention handled
    outside), against a full cache updated in place, through
    ``_decode_attention`` with no window."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = attention_qkv(
        p["attn"], h, pos[:, None], cfg.rope_theta, cfg.use_rope
    )
    update_cache(k_cache, k_new, pos)
    update_cache(v_cache, v_new, pos)
    update_pos(kv_pos, pos, 1)
    att = _decode_attention(q, k_cache, v_cache, pos, pages, kv_pos)
    return x + attention_out(p["attn"], att), k_cache, v_cache, kv_pos


def init_mamba_groups(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    """The hybrid's ``(n_super, attn_every, ...)`` Mamba2 stack (JAX:
    ``vmap(_init_mamba_group)``): a float32 norm scale and a Mamba2 layer
    per position."""
    lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every)
    return {
        "ln": torch.ones((*lead, cfg.d_model), dtype=torch.float32,
                         device=device),
        "mamba": ssm.init_mamba2(gen, cfg.d_model, cfg.ssm_state,
                                 cfg.conv_width, dtype, device, lead),
    }


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
    Returns (x, the pair's seven state tensors in ``SSM_STATE_KEYS`` order).
    The whole-prompt mLSTM runs the ``mlstm_chunk`` kernel, or on ``meta``
    tensors the plain chunkwise form in JAX's chunks."""
    hm = rms_norm(x, lp["ln_m"], cfg.norm_eps)
    if decode:
        y, m_state = ssm.mlstm_decode(lp["mlstm"], hm, m_state)
    elif hm.is_meta:
        y, m_state = ssm.mlstm_forward_train(lp["mlstm"], hm)
    else:
        y, m_state = ssm.mlstm_forward_chunked(lp["mlstm"], hm, m_state)
    x = x + y
    hs = rms_norm(x, lp["ln_s"], cfg.norm_eps)
    slstm = ssm.slstm_decode if decode else ssm.slstm_forward
    y2, s_state = slstm(lp["slstm"], hs, s_state)
    return x + y2, (*m_state, *s_state)


def stack_layers(stack) -> list:
    """Per-layer views of a layer-stacked tree (nested dicts of ``(L, ...)``
    tensors): entry l holds every leaf's ``[l]``.  Each leaf is split by
    one ``unbind``, whose backward stacks the layers' gradients once (a
    view per layer by indexing would give each layer's gradient its own
    zero-filled tensor of the whole stack's size)."""
    def split(tree):
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        return tree.unbind(0)

    def pick(tree, l):
        if isinstance(tree, dict):
            return {k: pick(v, l) for k, v in tree.items()}
        return tree[l]

    parts = split(stack)
    leaf = parts
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [pick(parts, l) for l in range(len(leaf))]


def _remat(fn, remat: bool):
    """``fn`` recomputed in the backward pass where ``remat`` (JAX:
    ``jax.checkpoint``)."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def embed_lookup(ids, table):
    """``F.embedding(ids, table)``.  A DTensor table split along the vocab
    is looked up on each rank's own rows (the ids outside them give 0), so
    the output is ``Partial`` over the vocab's mesh dims and the table is
    never gathered along the vocab; its other dims are gathered, and the
    ids keep their batch split elsewhere."""
    if not isinstance(table, DTensor):
        return F.embedding(ids, table)
    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    table = table.redistribute(mesh, [Shard(0) if v else Replicate()
                                      for v in vocab])
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ids = ids.redistribute(mesh, [
        Replicate() if v or not isinstance(p, Shard) else p
        for v, p in zip(vocab, ids.placements)])
    # every rank's lookups add to the table's gradient where the ids split
    local = table.to_local(grad_placements=[
        Shard(0) if v else (Partial() if isinstance(p, Shard) else
                            Replicate())
        for v, p in zip(vocab, ids.placements)])
    v0, n = local_offset(table, 0), local.shape[0]
    lid = ids.to_local().long()
    inside = (lid >= v0) & (lid < v0 + n)
    out = F.embedding(torch.where(inside, lid - v0, 0), local)
    out = out * inside[..., None].to(out.dtype)
    out_pl = [Partial() if v else p for v, p in zip(vocab, ids.placements)]
    shape = (*ids.shape, table.shape[1])
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def _gather_last(x, lens):
    """x: (B,S,D); lens: (B,) true lengths -> (B,1,D) at position lens-1."""
    return local_call(_gather_last_local, "bsd,b->bzd", x, lens, keep="b")


def _gather_last_local(x, lens):
    b = x.shape[0]
    idx = torch.clamp(lens.long() - 1, 0, x.shape[1] - 1)
    return x[torch.arange(b, device=x.device), idx][:, None, :]


# ===========================================================================
# the Model
# ===========================================================================


class Model:
    """Training and serving entry points of every family of the JAX
    ``Model`` on one device.

    ``device=None`` means ``cuda`` and raises when there is none; tests pass
    ``device="cpu"``.  ``debug_checks=True`` asserts the slot-contiguity
    precondition of paged decode after every decode step on a full cache.
    """

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 *, debug_checks: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.debug_checks = bool(debug_checks)
        #: stack key -> (the stacked tree, its per-layer views)
        self._views: dict[str, tuple[Any, list]] = {}

    # ------------------------------------------------------------ init

    def init(self, seed: int = 0) -> dict:
        """Seeded random parameters (a ``torch.Generator`` on the model's
        device; not JAX's numbers — parity tests bridge JAX's instead).  On
        the ``meta`` device, which has no generator, the leaves carry only
        their shapes and dtypes (the dry-run's parameter structure)."""
        cfg = self.cfg
        _check_family(cfg)
        dtype, dev = _dtype(cfg), self.device
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(int(seed)))
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
        elif cfg.kind == "encdec":
            params["enc_blocks"] = init_dense_blocks(
                gen, cfg, dtype, dev, lead=(cfg.n_enc_layers,))
            params["dec_blocks"] = init_decoder_blocks(gen, cfg, dtype, dev)
            params["enc_pos"] = (
                torch.randn((cfg.n_audio_frames, cfg.d_model), generator=gen,
                            device=dev) * 0.02
            ).to(dtype)
            params["enc_final_norm"] = torch.ones(
                (cfg.d_model,), dtype=torch.float32, device=dev)
        elif cfg.kind == "hybrid":
            params["super_blocks"] = init_mamba_groups(gen, cfg, dtype, dev)
            # zamba2's single SHARED attention+MLP block
            params["shared_attn"] = init_dense_blocks(gen, cfg, dtype, dev,
                                                      lead=())
        else:
            params["blocks"] = init_dense_blocks(gen, cfg, dtype, dev)
        return params

    def layer_params(self, params, key: Optional[str] = None) -> list:
        """Per-layer views of the family's main stack, kept while the same
        parameter dict is passed in (serving only: training indexes the
        stacks anew, so that its views carry the graph): ``params["blocks"]``,
        per-pair views
        of ``params["xlstm_pairs"]`` (ssm), of ``params["dec_blocks"]``
        (encdec; ``key="enc_blocks"`` gives the encoder's), or, for the
        hybrid, per super-block lists of per-layer views of
        ``params["super_blocks"]``."""
        cfg = self.cfg
        if key is None:
            key = {"ssm": "xlstm_pairs", "encdec": "dec_blocks",
                   "hybrid": "super_blocks"}.get(cfg.kind, "blocks")
        stack = params[key]
        # read once: a replicated fleet serves one model from several
        # threads, and each entry is replaced whole, never mutated
        views = self._views.get(key)
        if views is None or views[0] is not stack:
            layers = stack_layers(stack)
            if key == "super_blocks":
                layers = [stack_layers(group) for group in layers]
            views = (stack, layers)
            self._views[key] = views
        return views[1]

    # ------------------------------------------------------------ embed

    def _embed(self, params, tokens, positions):
        x = embed_lookup(tokens.long(), params["embed"])
        if not self.cfg.use_rope:
            x = x + embed_lookup(positions.long(), params["pos_emb"])
        return shard(x, "batch", "seq", "embed")

    def head_matrix(self, params):
        return (
            params["embed"].T if self.cfg.tie_embeddings
            else params["lm_head"]
        )

    def _logits(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = matmul(x, self.head_matrix(params), "bsd,dv->bsv")
        return shard(logits, "batch", "seq", "vocab")

    # ------------------------------------------------------------ train

    def hidden(self, params, batch: dict):
        """Training forward up to the FINAL NORM (no vocab projection).

        Returns (normed hidden states over the token positions, moe aux).
        The training loss projects to the vocab in chunks
        (``training.chunked_lm_loss``).  ``batch``: ``tokens`` (B,S),
        ``embeds`` for the vlm's image (prepended) and the encdec's audio
        frames."""
        cfg = self.cfg
        _check_family(cfg)
        tokens = batch["tokens"]
        b, s_tok = tokens.shape
        dev = tokens.device

        def arange_rows(n):
            return torch.arange(n, device=dev)[None].expand(b, n)

        if cfg.kind == "encdec":
            enc = batch["embeds"].to(_dtype(cfg))
            enc = enc + params["enc_pos"][None, : enc.shape[1]]
            enc = self._run_encoder(params, enc,
                                    stack_layers(params["enc_blocks"]))
            positions = arange_rows(s_tok)
            x = self._embed(params, tokens, positions)
            x, aux = self._run_decoder_train(params, x, positions, enc)
        elif cfg.kind == "vlm" and "embeds" in batch:
            img = batch["embeds"].to(_dtype(cfg))
            n_img = img.shape[1]
            positions = arange_rows(n_img + s_tok)
            x = torch.cat([img, embed_lookup(tokens.long(), params["embed"])],
                          dim=1)
            x = shard(x, "batch", "seq", "embed")
            x, aux = self._run_stack_train(params, x, positions)
            x = x[:, n_img:]
        else:
            positions = arange_rows(s_tok)
            x = self._embed(params, tokens, positions)
            x, aux = self._run_stack_train(params, x, positions)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, aux

    def forward(self, params, batch: dict):
        """Training forward returning full logits (small configs only)."""
        x, aux = self.hidden(params, batch)
        logits = matmul(x, self.head_matrix(params), "bsd,dv->bsv")
        return shard(logits, "batch", "seq", "vocab"), aux

    def _run_stack_train(self, params, x, positions, remat: bool = True):
        """The family's layer stack over the whole sequence, each layer
        (each super block, for the hybrid) recomputed in the backward pass
        where ``remat``.  Returns (x, summed moe aux)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.kind in ("dense", "moe", "vlm"):
            def body(h, lp):
                h, (_, _, a) = dense_block_train(lp, h, positions, cfg)
                return h, a

            body = _remat(body, remat)
            for lp in stack_layers(params["blocks"]):
                x, a = body(x, lp)
                x = shard(x, "batch", "seq", "embed")
                aux = aux + a
            return x, aux
        if cfg.kind == "ssm":
            def body(h, lp):
                hm = rms_norm(h, lp["ln_m"], cfg.norm_eps)
                h = h + ssm.mlstm_forward_train(lp["mlstm"], hm)[0]
                hs = rms_norm(h, lp["ln_s"], cfg.norm_eps)
                return h + ssm.slstm_forward(lp["slstm"], hs)[0]

            body = _remat(body, remat)
            for lp in stack_layers(params["xlstm_pairs"]):
                x = body(x, lp)
            return x, aux
        if cfg.kind == "hybrid":
            shared = params["shared_attn"]

            def mamba_one(hc, lp):
                hin = rms_norm(hc, lp["ln"], cfg.norm_eps)
                return hc + ssm.mamba2_forward_chunked(lp["mamba"], hin)[0]

            # JAX checkpoints each Mamba2 layer whatever ``remat`` says
            mamba_one = _remat(mamba_one, True)

            def body(h, group):
                for lp in stack_layers(group):
                    h = mamba_one(h, lp)
                return dense_block_train(shared, h, positions, cfg)[0]

            body = _remat(body, remat)
            for group in stack_layers(params["super_blocks"]):
                x = body(x, group)
            return x, aux
        raise ValueError(cfg.kind)

    def _run_decoder_train(self, params, x, positions, enc):
        """The encoder-decoder's decoder over the whole prompt: causal
        self-attention and cross-attention over the encoder output ``enc``,
        both on the plain attention, as JAX trains them."""
        cfg = self.cfg
        b, f = enc.shape[0], enc.shape[1]
        enc_pos = torch.arange(f, device=x.device)[None].expand(b, f)
        q_pos = torch.full_like(positions, f + 1)
        for lp in stack_layers(params["dec_blocks"]):
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = attention_qkv(lp["attn"], hn, positions,
                                    cfg.rope_theta, cfg.use_rope)
            att = attention_any(q, k, v, q_positions=positions,
                                kv_positions=positions)
            x = x + attention_out(lp["attn"], att)
            hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
            qx = project_heads(hx, lp["xattn"]["wq"])
            kx = project_heads(enc, lp["xattn"]["wk"])
            vx = project_heads(enc, lp["xattn"]["wv"])
            xat = attention_any(qx, kx, vx, q_positions=q_pos,
                                kv_positions=enc_pos)
            x = x + attention_out(lp["xattn"], xat)
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + gated_mlp(lp["mlp"], h2)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

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
        # one KV cache per attention layer (per application of the
        # hybrid's shared block)
        n = (cfg.n_layers // cfg.attn_every if cfg.kind == "hybrid"
             else cfg.n_layers)
        shape = (n, batch, t, cfg.n_kv_heads, cfg.head_dim)
        cache = {
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "kv_pos": torch.full(shape[:3], -1, dtype=torch.int32,
                                 device=dev),
        }
        if cfg.kind == "encdec":
            cross = (n, batch, cfg.n_audio_frames, cfg.n_kv_heads,
                     cfg.head_dim)
            cache["cross_k"] = torch.zeros(cross, dtype=_dtype(cfg),
                                           device=dev)
            cache["cross_v"] = torch.zeros(cross, dtype=_dtype(cfg),
                                           device=dev)
            cache["enc_len"] = torch.zeros((batch,), dtype=torch.int32,
                                           device=dev)
        if cfg.kind == "hybrid":
            d_inner, pdim, h, n_state = ssm.mamba2_dims(cfg.d_model,
                                                        cfg.ssm_state)
            lead = (n, cfg.attn_every, batch)
            cache["mamba_h"] = torch.zeros((*lead, h, pdim, n_state),
                                           dtype=torch.float32, device=dev)
            cache["mamba_conv"] = torch.zeros(
                (*lead, cfg.conv_width - 1, d_inner + 2 * n_state),
                dtype=_dtype(cfg), device=dev)
        return cache

    @torch.no_grad()
    def prefill(self, params, batch: dict, cache_len: int, *,
                cache: Optional[dict] = None):
        """Process the full prompt; returns (last-position logits, cache).

        batch: {"tokens": (B,S), optional "embeds", optional "lens": (B,)}.
        ``embeds``: the VLM's image embeddings (B, n_image, D), prepended
        to the text (``lens`` counts the text; the image is added to it),
        or the encoder-decoder's audio frames (B, F, D), which it needs.
        Other families ignore them, as in JAX.

        On ``meta`` tensors (the dry-run's plans) it runs JAX's plain
        attention and plain chunkwise mLSTM in place of the flash and mLSTM
        kernels.  ``cache``: an empty cache of ``init_cache``'s shapes to
        fill (a sharded plan's DTensors), else one is made.
        """
        cfg = self.cfg
        _check_family(cfg)
        tokens = batch["tokens"]
        b, s = tokens.shape
        dev = tokens.device
        lens = batch.get("lens")
        if lens is None:
            lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        if cache is None:
            cache = self.init_cache(params, b, cache_len)
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        if cfg.kind == "vlm" and "embeds" in batch:
            img = batch["embeds"].to(_dtype(cfg))
            x = torch.cat([img, embed_lookup(tokens.long(), params["embed"])],
                          dim=1)
            x = shard(x, "batch", "seq", "embed")
            s = x.shape[1]
            positions = torch.arange(s, device=dev)[None].expand(b, s)
            lens = lens + img.shape[1]  # prompt = image tokens + text
        else:
            x = self._embed(params, tokens, positions)
        if cfg.kind == "ssm":
            # every row runs its whole S tokens (the engine prefills ssm
            # prompts one at a time at their exact length)
            for l, lp in enumerate(self.layer_params(params)):
                x, states = xlstm_pair(lp, x, cfg, None, None, decode=False)
                for key, st in zip(SSM_STATE_KEYS, states):
                    cache[key][l] = st
            return self._logits(params, _gather_last(x, lens)), cache
        if cfg.kind == "encdec":
            x, ks, vs = self._decoder_prefill(params, batch["embeds"], x,
                                              positions, cache)
        elif cfg.kind == "hybrid":
            x, ks, vs = self._hybrid_prefill(params, x, positions, lens,
                                             cache)
        else:
            ks, vs = [], []
            for lp in self.layer_params(params):
                x, (k, v, _) = dense_block_prefill(lp, x, positions, lens,
                                                   cfg)
                x = shard(x, "batch", "seq", "embed")
                ks.append(k)
                vs.append(v)
        cache = self._fill_kv(cache, ks, vs, lens, s)
        logits = self._logits(params, _gather_last(x, lens))
        return logits, cache

    def _run_encoder(self, params, enc, layers):
        """The bidirectional encoder over frame embeddings (B, F, D) on the
        plain attention (a query position past every frame, so that every
        key passes the causal comparison, as JAX builds it), then its
        final norm.  ``layers``: the per-layer views of
        ``params["enc_blocks"]``."""
        cfg = self.cfg
        b, f, _ = enc.shape
        positions = torch.arange(f, device=enc.device)[None].expand(b, f)
        q_pos = torch.full((b, f), f + 1, dtype=torch.int32,
                           device=enc.device)
        for lp in layers:
            hn = rms_norm(enc, lp["ln1"], cfg.norm_eps)
            q, k, v = attention_qkv(lp["attn"], hn, positions,
                                    cfg.rope_theta, False)
            att = gqa_attention(q, k, v, q_positions=q_pos,
                                kv_positions=positions)
            enc = enc + attention_out(lp["attn"], att)
            h2 = rms_norm(enc, lp["ln2"], cfg.norm_eps)
            enc = enc + gated_mlp(lp["mlp"], h2)
        return rms_norm(enc, params["enc_final_norm"], cfg.norm_eps)

    def _decoder_prefill(self, params, frames, x, positions, cache):
        """The encoder over ``frames`` (B, F, D) plus ``enc_pos``, then the
        decoder layers over the prompt embeddings ``x``: causal
        self-attention through ``_prefill_attention``, cross-attention on
        the plain attention.  Writes ``cross_k``/``cross_v`` (L, B, F, ...)
        into the cache; returns x and the self-attention K/V per layer."""
        cfg = self.cfg
        enc = frames.to(_dtype(cfg))
        f = enc.shape[1]
        enc = self._run_encoder(params, enc + params["enc_pos"][None, :f],
                                self.layer_params(params, "enc_blocks"))
        b = x.shape[0]
        enc_pos = torch.arange(f, device=x.device)[None].expand(b, f)
        q_pos = torch.full_like(positions, f + 1)
        ks, vs, kxs, vxs = [], [], [], []
        for lp in self.layer_params(params):
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = attention_qkv(lp["attn"], hn, positions,
                                    cfg.rope_theta, cfg.use_rope)
            att = _prefill_attention(q, k, v, positions, None, 0)
            x = x + attention_out(lp["attn"], att)
            hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
            kx = project_heads(enc, lp["xattn"]["wk"])
            vx = project_heads(enc, lp["xattn"]["wv"])
            qx = project_heads(hx, lp["xattn"]["wq"])
            xat = attention_any(qx, kx, vx, q_positions=q_pos,
                                kv_positions=enc_pos)
            x = x + attention_out(lp["xattn"], xat)
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + gated_mlp(lp["mlp"], h2)
            ks.append(k)
            vs.append(v)
            kxs.append(kx)
            vxs.append(vx)
        # JAX replaces the cross cache with the frames' own (F may differ
        # from the config's n_audio_frames)
        cross_k, cross_v = torch.stack(kxs), torch.stack(vxs)
        if isinstance(cache["cross_k"], DTensor):
            cross_k = cross_k.redistribute(cache["cross_k"].device_mesh,
                                           cache["cross_k"].placements)
            cross_v = cross_v.redistribute(cache["cross_v"].device_mesh,
                                           cache["cross_v"].placements)
        cache["cross_k"], cache["cross_v"] = cross_k, cross_v
        return x, ks, vs

    def _hybrid_prefill(self, params, x, positions, lens, cache):
        """Each super block: its Mamba2 layers (chunkwise SSD, every row's
        whole S, padding included, as JAX runs them), writing their final
        states into the cache, then the shared attention block
        (``dense_block_prefill``).  Returns x and the shared block's K/V per
        application."""
        cfg = self.cfg
        shared = params["shared_attn"]
        ks, vs = [], []
        for l, group in enumerate(self.layer_params(params)):
            for j, lp in enumerate(group):
                hin = rms_norm(x, lp["ln"], cfg.norm_eps)
                y, (st, conv) = ssm.mamba2_forward_chunked(lp["mamba"], hin)
                x = x + y
                cache["mamba_h"][l, j] = st
                cache["mamba_conv"][l, j] = conv
            x, (k, v, _) = dense_block_prefill(shared, x, positions, lens,
                                               cfg, padded_rows=True)
            ks.append(k)
            vs.append(v)
        return x, ks, vs

    @torch.no_grad()
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

    @torch.no_grad()
    def prefill_slice(self, params, cache: dict, tokens, slot: int,
                      start: int, total: int):
        """One bounded prefill slice of a SINGLE batch slot against a live
        decode cache — the serving engine's fused prefill-in-window unit.

        ``tokens``: (S,) int chunk of the prompt (zero-padded past the
        prompt's end); ``slot``/``start``/``total``: host ints — the cache
        row being prefilled, the slice's absolute write offset and the full
        prompt length.  Follows ``dense_block_chunk``'s rule per layer:
        write the slice's K/V first (``kv_pos`` at or beyond ``total``
        written as -1), then attend the queries over the slot's whole cache
        with ``kv_pos <= q_pos`` masking the chunk-internal future and
        ``kv_pos >= 0`` the unwritten rows.  Rows at or past the cache end
        are dropped, as JAX's scatter with ``mode="drop"`` drops them: a
        padded tail never moves the slice onto valid rows the way a
        clamped ``update_cache`` write would.

        Returns ``(logits (V,), cache)``, the logits at the prompt's final
        position clipped into this slice: the first-token distribution
        when this slice completes the prompt, garbage otherwise.  Dense
        and MoE families (the MoE's capacities over the slice's S tokens,
        as in JAX); ring layouts are gated out by the engine.
        """
        cfg = self.cfg
        if cfg.kind not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"prefill_slice: unsupported model kind {cfg.kind!r}"
            )
        _check_family(cfg)
        s = tokens.shape[0]
        dev = tokens.device
        idx = start + torch.arange(s, dtype=torch.int32, device=dev)
        positions = idx[None]
        x = self._embed(params, tokens[None], positions)
        # rows below the cache end only: the rest of the slice is dropped
        n = max(0, min(s, cache["k"].shape[2] - start))
        rows = slice(start, start + n)
        kv_new = idx[:n].masked_fill(idx[:n] >= total, -1)
        for l, lp in enumerate(self.layer_params(params)):
            kc, vc = cache["k"][l, slot], cache["v"][l, slot]
            kp = cache["kv_pos"][l, slot]
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k_new, v_new = attention_qkv(
                lp["attn"], h, positions, cfg.rope_theta, cfg.use_rope
            )
            kc[rows] = k_new[0, :n].to(kc.dtype)
            vc[rows] = v_new[0, :n].to(vc.dtype)
            kp[rows] = kv_new
            att = attention_any(
                q, kc[None], vc[None],
                window=cfg.sliding_window,
                q_positions=positions,
                kv_positions=kp[None],
                kv_valid=kp[None] >= 0,
            )
            x = x + attention_out(lp["attn"], att)
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + block_ffn(lp, h2, cfg)[0]
        last = min(max(total - 1 - start, 0), s - 1)
        logits = self._logits(params, x[:, last][:, None, :])
        return logits[0, 0], cache

    def _fill_kv(self, cache, ks, vs, lens, s):
        """Copy prefill K/V (per layer (B,S,n,h)) into the fresh cache's
        first S rows, kv_pos = arange(S); or, where a ring (sliding-window)
        cache of T < S rows, the prompt's last T tokens into rows 0..T-1,
        kv_pos = arange(S-T, S).  Either way kv_pos is -1 at and past each
        row's length.

        The ring branch is the JAX package's, quirks included: row j holds
        position S-T+j although decode writes position p at row p mod T
        (so a later wrap can overwrite a row still inside the window), and
        a row shorter than the batch's S loses its head rows, even when
        its own prompt fits in the window."""
        t = cache["k"].shape[2]
        dev = lens.device
        if self.cfg.sliding_window and t < s:
            rows, kvp = slice(None), torch.arange(s - t, s, dtype=torch.int32,
                                                  device=dev)
            ks, vs = [k[:, -t:] for k in ks], [v[:, -t:] for v in vs]
        elif s <= t:
            rows, kvp = slice(0, s), torch.arange(s, dtype=torch.int32,
                                                  device=dev)
        else:
            raise ValueError(f"a prompt of {s} tokens does not fit a cache "
                             f"of {t} rows")
        for l, (k, v) in enumerate(zip(ks, vs)):
            cache["k"][l, :, rows] = k
            cache["v"][l, :, rows] = v
        kvp = torch.where(kvp[None] < lens[:, None], kvp[None],
                          torch.full((), -1, dtype=torch.int32, device=dev))
        cache["kv_pos"][:, :, rows] = kvp
        return cache

    @torch.no_grad()
    def decode(self, params, cache: dict, tokens, pos):
        """One decode step.  tokens: (B,1) int; pos: (B,) positions of the
        new token.  Returns (logits (B,1,V), cache updated in place).  On
        ``meta`` tensors (the dry-run's plans) it runs JAX's masked
        attention over the cache in place of the paged kernel."""
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
        # JAX's rule, which reads a cache of exactly ``window`` rows as a
        # ring even where the engine's (``window < cache_len``) does not:
        # below the window both write position p at row p
        ring = bool(cfg.sliding_window) and (
            cache["k"].shape[2] == cfg.sliding_window
        )
        # one page table, and on the fused path one set of rotary tables,
        # for every layer of a step on a full cache
        b, t = cache["k"].shape[1:3]
        pages = (None if ring or isinstance(cache["k"], DTensor)
                 else slot_pages(b, t, pos))
        rope = (rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta,
                            x.device)
                if fused_decode_path(x, cache["k"], cfg, ring) else None)
        kv = [(cache["k"][l], cache["v"][l], cache["kv_pos"][l])
              for l in range(cache["k"].shape[0])]
        if cfg.kind == "encdec":
            x = self._decoder_decode(params, x, pos, kv, cache, pages)
        elif cfg.kind == "hybrid":
            shared = params["shared_attn"]
            for l, group in enumerate(self.layer_params(params)):
                for j, lp in enumerate(group):
                    hin = rms_norm(x, lp["ln"], cfg.norm_eps)
                    st, conv = cache["mamba_h"][l, j], cache["mamba_conv"][l, j]
                    y, (new_st, new_conv) = ssm.mamba2_decode(
                        lp["mamba"], hin, st, conv)
                    x = x + y
                    st.copy_(new_st)
                    conv.copy_(new_conv)
                x = dense_block_decode(shared, x, pos, *kv[l], cfg, ring,
                                       pages, rope)[0]
        else:
            for lp, layer_kv in zip(self.layer_params(params), kv):
                x = dense_block_decode(lp, x, pos, *layer_kv, cfg, ring,
                                       pages, rope)[0]
        if self.debug_checks and not ring:
            check_slot_contiguous(cache["kv_pos"], pos)
        return self._logits(params, x), cache

    def _decoder_decode(self, params, x, pos, kv, cache, pages):
        """The encoder-decoder's decode layers: self-attention through the
        paged kernel (``dense_block_decode_selfonly``), then
        cross-attention on the plain attention over the cached
        ``cross_k``/``cross_v``, then the gated MLP."""
        cfg = self.cfg
        b = x.shape[0]
        f = cache["cross_k"].shape[2]
        enc_pos = torch.arange(f, device=x.device)[None].expand(b, f)
        q_pos = torch.full((b, 1), f + 1, dtype=torch.int32, device=x.device)
        for l, lp in enumerate(self.layer_params(params)):
            x = dense_block_decode_selfonly(lp, x, pos, *kv[l], cfg,
                                            pages)[0]
            hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
            qx = project_heads(hx, lp["xattn"]["wq"])
            xat = gqa_attention(qx, cache["cross_k"][l], cache["cross_v"][l],
                                q_positions=q_pos, kv_positions=enc_pos)
            x = x + attention_out(lp["xattn"], xat)
            hm = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + gated_mlp(lp["mlp"], hm)
        return x
