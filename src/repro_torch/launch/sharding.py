"""Sharding policy: logical-axis rules and the parameter, optimizer, batch
and cache specs.  The port's counterpart of ``repro.launch.sharding``,
its logic line for line over the port's parameter dict (JAX's keys).

Baseline scheme (the JAX package's DESIGN.md §5):
  * activations: batch -> ("pod","data"); ffn/vocab/experts/head_dim ->
    "model"; heads -> None.  head_dim sharding is the universal baseline:
    every assigned arch has head_dim % 16 == 0 while several have
    n_heads % 16 != 0 (llama3.2 24H, llava 56H, starcoder2 36H, whisper 6H).
  * params: 2-D sharded: the d_model axis over "data" (FSDP) x the output
    axis over "model" (tensor parallel).  Optimizer states inherit the
    parameter specs (ZeRO).
  * pods replicate params; gradients reduce over "pod" (+"data").

A spec is a ``shardlib.P``; ``shardlib.to_placements`` turns it into the
DTensor placements of a ``DeviceMesh``.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.shardlib import P
from repro_torch.training.optimizer import AdamState
from repro_torch.tree import tree_map_with_path


def axis_size(mesh, name: str) -> int:
    """The degree of a named mesh axis (JAX: ``mesh.shape[name]``)."""
    return mesh.size(list(mesh.mesh_dim_names).index(name))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def make_rules(cfg: ModelConfig, mesh, *, shard_batch: bool = True,
               attn_mode: str = "head_dim") -> dict:
    """Logical activation-axis -> mesh-axis rules (see models/shardlib).

    Divisibility-aware: an axis whose size does not divide the "model"
    degree is left unsharded (e.g. whisper/granite vocabs 51865/49155,
    mixtral's 8 experts on a 16-way model axis).
    """
    mp = axis_size(mesh, "model")
    b_axes = batch_axes(mesh) if shard_batch else None
    heads = "model" if attn_mode == "heads" and cfg.n_heads % mp == 0 else None
    hd = "model" if attn_mode == "head_dim" and cfg.head_dim % mp == 0 else None
    kvh = (
        "model"
        if attn_mode == "heads" and cfg.n_kv_heads % mp == 0
        else None
    )
    return {
        "batch": b_axes,
        "seq": None,
        "heads": heads,
        "kv_heads": kvh,
        "head_dim": hd,
        # context parallelism (O4): the q-chunk axis on "model" for archs
        # whose heads do not divide the model degree
        "q_chunks": "model" if attn_mode == "context" else None,
        # kept disabled, as in JAX (its §Perf iteration 5 refuted it)
        "head_dim_proj": None,
        "embed": None,
        # expert-parallel archs put experts on "model"; the ffn dim then
        # stays local.  MoE archs whose expert count does NOT divide the
        # axis (mixtral 8e) fall back to tensor-parallel ffn sharding.
        "ffn": (
            None
            if (cfg.n_experts and cfg.n_experts % mp == 0)
            else ("model" if (cfg.d_ff == 0 or cfg.d_ff % mp == 0) else None)
        ),
        "vocab": "model" if cfg.vocab % mp == 0 else None,
        "experts": "model" if cfg.n_experts and cfg.n_experts % mp == 0
        else None,
    }


# --------------------------------------------------------------- parameters


def _param_base_spec(path_keys: list[str], shape: tuple, cfg: ModelConfig,
                     attn_mode: str, mesh, fsdp: bool = True) -> P:
    """Spec for the TRAILING dims of a leaf; leading stack dims -> None.

    Every chosen axis is validated against the actual dim size: a mesh
    axis whose degree does not divide the dim is dropped (replicated).
    ``fsdp=False`` (serving): weights replicate over "data" — latency paths
    must not all-gather weights every step.
    """
    ndim = len(shape)
    name = path_keys[-1]
    ctx = set(path_keys)
    model_par = axis_size(mesh, "model")
    E = "data" if fsdp else None  # d_model axis of params
    heads = "model" if attn_mode == "heads" else None
    # context mode (O4): attention WEIGHTS stay head_dim-sharded (memory,
    # and the projections compute sharded); only the q/k/v ACTIVATIONS are
    # gathered at the attention boundary — attention itself is q-chunk
    # parallel.  Replicating the projection weights instead was measured to
    # 2.8x the per-device FLOPs (§Perf iteration 4).
    hd = "model" if attn_mode in ("head_dim", "context") else None

    if "attn" in ctx or "xattn" in ctx or "shared_attn" in ctx:
        if name in ("wq", "wk", "wv"):
            base = (E, heads, hd)                 # (D, n, h)
        elif name == "wo":
            base = (heads, hd, E)                 # (n, h, D)
        elif name in ("w1", "w3"):
            base = (E, "model")                   # (D, F)
        elif name == "w2":
            base = ("model", E)                   # (F, D)
        else:
            base = ()
    elif "moe" in ctx:
        # experts shard over "model" when the count divides it (dbrx 16e);
        # otherwise fall back to tensor-parallel F sharding (mixtral 8e)
        ep = cfg.n_experts % model_par == 0
        if name == "router":
            base = (E, None)                      # (D, E#)
        elif name in ("w1", "w3"):
            base = ("model", E, None) if ep else (None, E, "model")
        elif name == "w2":
            base = ("model", None, E) if ep else (None, "model", E)
        else:
            base = ()
    elif "mlp" in ctx:
        if name in ("w1", "w3"):
            base = (E, "model")
        elif name == "w2":
            base = ("model", E)
        else:
            base = ()
    elif "mamba" in ctx:
        if name == "w_in":
            base = (E, "model")                   # (D, 2di+2n+h)
        elif name == "w_out":
            base = ("model", E)                   # (di, D)
        else:
            base = ()                             # conv/gates: tiny
    elif "mlstm" in ctx:
        if name in ("wq", "wk", "wv"):
            base = (E, None, "model")             # (D, H, hd)
        elif name == "wo":
            base = (None, "model", E)             # (H, hd, D)
        else:
            base = ()
    elif "slstm" in ctx:
        if name == "w_in":
            base = (E, None, "model", None)       # (D, H, hd, 4)
        elif name == "r":
            base = (None, "model", None, None)    # (H, hd, hd, 4)
        elif name == "wo":
            base = (None, "model", E)
        else:
            base = ()
    elif name == "embed":
        base = ("model", E)                       # (V, D)
    elif name == "lm_head":
        base = (E, "model")                       # (D, V)
    else:
        base = ()                                 # norms, pos tables, gates

    if len(base) > ndim:
        base = base[-ndim:] if ndim else ()
    pad = (None,) * (ndim - len(base))
    full = list(pad + tuple(base))
    # divisibility safety net: drop any axis that does not divide the dim
    for i, ax in enumerate(full):
        if ax is None:
            continue
        degree = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            degree *= axis_size(mesh, a)
        if shape[i] % degree:
            full[i] = None
    return P(*full)


def param_pspecs(params, cfg: ModelConfig, mesh, *,
                 attn_mode: str = "head_dim", fsdp: bool = True):
    """Spec tree matching the params tree (any leaves with a ``shape``)."""

    def one(path, leaf):
        return _param_base_spec(list(path), tuple(leaf.shape), cfg,
                                attn_mode, mesh, fsdp=fsdp)

    return tree_map_with_path(one, params)


def opt_pspecs(param_specs) -> AdamState:
    return AdamState(step=P(), m=param_specs, v=param_specs)


# ------------------------------------------------------------ batch / cache


def train_batch_pspecs(cfg: ModelConfig, mesh) -> dict:
    specs = {"tokens": P(batch_axes(mesh), None)}
    if cfg.kind in ("encdec", "vlm"):
        specs["embeds"] = P(batch_axes(mesh), None, None)
    return specs


def cache_pspecs(cfg: ModelConfig, mesh, cache, *, shard_batch: bool,
                 shard_seq: bool, seq_axis: str = "batch") -> dict:
    """Specs for the decode cache dict (shapes from Model.init_cache).

    ``shard_seq`` with ``seq_axis="model"`` gives flash-decoding-style
    sequence-parallel attention: the KV sequence dim lives on the model
    axis (the JAX package's §Perf optimization O3).
    """
    b = batch_axes(mesh) if shard_batch else None
    if shard_seq:
        t = batch_axes(mesh) if seq_axis == "batch" else "model"
    else:
        t = None
    # hd and T cannot both live on "model"
    hd = None if t == "model" else "model"

    def one(path, leaf):
        name = path[-1]
        if name in ("k", "v"):           # (L,B,T,nkv,hd)
            return P(None, b, t, None, hd)
        if name in ("cross_k", "cross_v"):
            return P(None, b, None, None, hd)
        if name == "kv_pos":             # (L,B,T)
            return P(None, b, t)
        if name == "enc_len":
            return P(b)
        if name == "mlstm_c":            # (Pair,B,H,hd,hd)
            return P(None, b, None, "model", None)
        if name in ("mlstm_n",):         # (Pair,B,H,hd)
            return P(None, b, None, "model")
        if name == "mlstm_m":            # (Pair,B,H)
            return P(None, b, None)
        if name in ("slstm_c", "slstm_n", "slstm_h", "slstm_m"):
            return P(None, b, None, "model")
        if name == "mamba_h":            # (NS,AE,B,H,P,N)
            return P(None, None, b, "model", None, None)
        if name == "mamba_conv":         # (NS,AE,B,W-1,C)
            return P(None, None, b, None, "model")
        return P(*([None] * leaf.ndim))

    return tree_map_with_path(one, cache)
