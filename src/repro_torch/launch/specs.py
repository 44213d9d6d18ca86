"""Plan construction for every (architecture x input-shape) pair on a mesh:
the port's counterpart of ``repro.launch.specs``.

``build_dryrun(arch, shape, mesh)`` returns the step function and its
arguments as DTensors laid out by the sharding policy
(``launch/sharding.py``).  Where JAX builds ``ShapeDtypeStruct``s with
``jax.eval_shape``, the dry-run builds parameters, optimizer state, caches
and batches as DTensors over ``meta`` local shards
(``DTensor.from_local(..., run_check=False, shape=..., stride=...)``):
nothing is allocated.  Given real tensors (``params=``, ``batch=``) on a
real mesh the same plan runs eagerly (``lower_plan``), each rank taking its
own shard of the full tensors, which every rank holds alike.

A plan picks the plain attention and the plain chunkwise mLSTM by its
``kernels`` argument (off in the dry-run, as JAX lowers jnp there): the
kernel wrappers launch for every tensor not on the CPU, ``meta``
included, and fail there.  ``lower_plan`` runs a plan under its mesh and
rules, where JAX lowers it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import INPUT_SHAPES, get_config, supports_shape
from repro_torch.launch.sharding import (
    axis_size,
    batch_axes,
    cache_pspecs,
    make_rules,
    opt_pspecs,
    param_pspecs,
)
from repro_torch.models import Model
from repro_torch.models.shardlib import (
    P,
    contiguous_stride,
    to_placements,
    use_sharding,
)
from repro_torch.training import AdamWConfig, init_adamw, make_train_step
from repro_torch.training.optimizer import AdamState
from repro_torch.tree import tree_leaves, tree_map


class DryrunPlan(NamedTuple):
    fn: Callable
    args: tuple                    # DTensor trees
    in_specs: tuple                # spec trees of ``args``
    rules: dict
    cfg: Any
    mode: str
    mesh: Any


def _act_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def distribute(x, mesh, spec):
    """``x`` as a DTensor laid out by ``spec``: on ``meta`` an empty local
    shard of the right shape, else this rank's shard of ``x`` (which every
    rank holds whole).  An already distributed ``x`` is redistributed."""
    placements = to_placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    local_shape, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, placements)
    if x.device.type == "meta":
        local = torch.empty(local_shape, dtype=x.dtype, device="meta")
    elif tuple(local_shape) == tuple(x.shape):
        local = x
    else:
        local = x[tuple(slice(o, o + n) for o, n in
                        zip(offset, local_shape))].contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=tuple(x.shape),
                              stride=contiguous_stride(x.shape))


def distribute_tree(tree, mesh, specs):
    if isinstance(tree, AdamState):
        return AdamState(*(distribute_tree(t, mesh, s)
                           for t, s in zip(tree, specs)))
    return tree_map(lambda x, s: distribute(x, mesh, s), tree, specs)


def input_specs(arch: str, shape_name: str, *, batch_override: int = 0,
                cfg=None, seq_override: int = 0) -> dict:
    """``meta`` stand-ins for every model input of this pair."""
    shape = INPUT_SHAPES[shape_name]
    cfg = cfg or get_config(arch, shape=shape_name)
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict[str, Any] = {}
    if shape.mode in ("train", "prefill"):
        out["tokens"] = meta((b, s), torch.int32)
        if cfg.kind == "encdec":
            out["embeds"] = meta((b, cfg.n_audio_frames, cfg.d_model),
                                 _act_dtype(cfg))
        if cfg.kind == "vlm":
            out["embeds"] = meta((b, cfg.n_image_tokens, cfg.d_model),
                                 _act_dtype(cfg))
        if shape.mode == "prefill":
            out["lens"] = meta((b,), torch.int32)
    else:  # decode: one new token against a seq_len cache
        out["tokens"] = meta((b, 1), torch.int32)
        out["pos"] = meta((b,), torch.int32)
    return out


def plan_layout(cfg, mesh, mode: str, b: int, *, attn_mode: str,
                optimized: bool) -> tuple[str, bool, bool]:
    """(attn_mode, fsdp, shard_batch) of a plan: the JAX package's §Perf
    scheme where ``optimized`` (O1 head sharding or O4 context parallelism
    for train/prefill, O2 no FSDP for serving)."""
    fsdp = True
    if optimized:
        if mode in ("train", "prefill"):
            if cfg.n_heads % axis_size(mesh, "model") == 0:
                attn_mode = "heads"                      # O1
            elif cfg.kind in ("dense", "moe", "vlm", "encdec"):
                attn_mode = "context"                    # O4
        if mode in ("prefill", "decode"):
            fsdp = False                                 # O2
    return attn_mode, fsdp, b > 1


def build_dryrun(arch: str, shape_name: str, mesh,
                 *, batch_override: int = 0,
                 attn_mode: str = "head_dim", cfg_override=None,
                 seq_override: int = 0, optimized: bool = False,
                 params=None, batch: Optional[dict] = None,
                 cache_len: int = 0,
                 cache: Optional[dict] = None) -> DryrunPlan:
    """``optimized=True`` applies the JAX package's §Perf sharding scheme:
      O1 train/prefill: head-sharded attention when n_heads divides the
         model axis, else O4 context parallelism (q chunks on "model");
      O2 serving (prefill/decode): no FSDP, weights replicate over "data";
      O3 decode: KV cache sequence dim sharded over "model".

    ``params``/``batch``: real tensors to shard (the whole tree on every
    rank), whose serving plans run the kernels' route; by default ``meta``
    stand-ins, whose plans run JAX's plain composition (``Model.prefill``).
    ``cache_len``: the prefill plan's cache rows (default: the prompt's).
    ``cache``: the decode plan's cache (a prefill plan's output, say),
    else an empty one of ``seq_len`` rows.
    """
    if not supports_shape(arch, shape_name):
        raise ValueError(f"{arch} skips {shape_name} (DESIGN.md §4)")
    shape = INPUT_SHAPES[shape_name]
    if seq_override:
        shape = dataclasses.replace(shape, seq_len=seq_override)
    cfg = cfg_override or get_config(arch, shape=shape_name)
    device = "meta" if params is None else tree_leaves(params)[0].device
    model = Model(cfg, device=device)
    b = batch_override or shape.global_batch
    s = shape.seq_len
    mode = shape.mode
    attn_mode, fsdp, shard_batch = plan_layout(
        cfg, mesh, mode, b, attn_mode=attn_mode, optimized=optimized)
    rules = make_rules(cfg, mesh, shard_batch=shard_batch,
                       attn_mode=attn_mode)
    b_ax = batch_axes(mesh) if shard_batch else None

    if params is None:
        params = model.init()
    pspecs = param_pspecs(params, cfg, mesh, attn_mode=attn_mode, fsdp=fsdp)
    dparams = distribute_tree(params, mesh, pspecs)
    if batch is None:
        batch = input_specs(arch, shape_name, batch_override=b, cfg=cfg,
                            seq_override=s)
    bspecs = {k: P(*((b_ax,) + (None,) * (v.ndim - 1)))
              for k, v in batch.items()}
    dbatch = {k: distribute(v, mesh, bspecs[k]) for k, v in batch.items()}

    def plan(fn, args, in_specs, mode):
        return DryrunPlan(fn=fn, args=args, in_specs=in_specs, rules=rules,
                          cfg=cfg, mode=mode, mesh=mesh)

    if mode == "train":
        opt = init_adamw(params)
        ospecs = opt_pspecs(pspecs)
        dopt = distribute_tree(opt, mesh, ospecs)
        step = make_train_step(model, AdamWConfig())
        return plan(step, (dparams, dopt, dbatch), (pspecs, ospecs, bspecs),
                    "train")

    if mode == "prefill":
        n_img = cfg.n_image_tokens if cfg.kind == "vlm" else 0
        rows = cache_len or s + n_img
        cache_struct = Model(cfg, device="meta").init_cache(None, b, rows)
        cspecs = cache_pspecs(cfg, mesh, cache_struct,
                              shard_batch=shard_batch, shard_seq=False)

        def prefill_fn(params, batch):
            # the output cache, laid out as JAX's out_shardings say
            cache = model.init_cache(params, b, rows)
            cache = {k: distribute(v, mesh, cspecs[k])
                     for k, v in cache.items()}
            return model.prefill(params, batch, cache_len=rows, cache=cache)

        return plan(prefill_fn, (dparams, dbatch), (pspecs, bspecs),
                    "prefill")

    # decode: one token against a seq_len-deep cache
    if cache is None:
        cache = Model(cfg, device=device).init_cache(None, b, s)
    # long-context decode with batch=1 shards the cache SEQUENCE dim over
    # the batch axes; optimized BATCHED decode shards it over "model" (O3,
    # not applied at batch=1: JAX measured a 400x regression there)
    shard_seq = (not shard_batch) or optimized
    cspecs = cache_pspecs(
        cfg, mesh, cache, shard_batch=shard_batch, shard_seq=shard_seq,
        seq_axis="model" if (optimized and shard_batch) else "batch")
    dcache = {k: distribute(v, mesh, cspecs[k]) for k, v in cache.items()}

    def decode_fn(params, cache, tokens, pos):
        return model.decode(params, cache, tokens, pos)

    return plan(decode_fn, (dparams, dcache, dbatch["tokens"],
                            dbatch["pos"]),
                (pspecs, cspecs, bspecs["tokens"], bspecs["pos"]), "decode")


def lower_plan(plan: DryrunPlan, *args):
    """Run the plan under its mesh and rules (the counterpart of JAX's
    ``jit(...).lower``), on ``args`` where given (laid out as the plan's
    own), else on its own: plain tensors made inside the model
    (positions, masks) act as replicated."""
    with use_sharding(plan.mesh, plan.rules), implicit_replication():
        return plan.fn(*(args or plan.args))
