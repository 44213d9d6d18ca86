"""Multi-pod dry-run: the port's counterpart of ``repro.launch.dryrun``.
Runs every (architecture x input-shape) pair on the production meshes
WITHOUT allocating device memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl

The meshes are ``DeviceMesh``es over a fake process group of 256 or 512
ranks (``torch.distributed``'s ``fake`` backend: this process is rank 0,
no collective moves data), made in ``run_pair``, never at import.  The
plan (``launch/specs.py``) runs eagerly on DTensors over ``meta`` local
shards, under ``launch/op_analysis.OpCounter``, which counts what rank 0
runs: per-device FLOPs, bytes at op boundaries and collectives.

The layers of a stack cost the same, and a Python loop runs each one (JAX
traces one scan body and multiplies it by the trip count).  So, as
``hlo_analysis`` scales loop bodies, a pair whose stack has G > 2 groups
(a layer; an mLSTM/sLSTM pair; a hybrid super block; an encoder plus a
decoder layer) is traced at 1 and at 2 groups and its counts are
``c(1) + (G - 1) * (c(2) - c(1))``, exact for counts affine in the depth
(``tests/test_torch_dryrun.py`` holds it to a full trace).

Per pair it records: the status, the mode, ``memory.argument_bytes`` (the
bytes of this rank's shards of the plan's arguments, at full depth),
``cost`` (FLOPs and bytes accessed), the collectives per kind, and the
parameter counts.  ``memory.peak_bytes`` is null: ``meta`` tensors have no
allocator, so no peak of live memory is observed (torch's memory tracker
follows a device's caching allocator, which a meta run never calls).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs import supports_shape
from repro_torch.launch.mesh import make_production_mesh, production_layout
from repro_torch.launch.op_analysis import OpStats, count_ops
from repro_torch.launch.specs import build_dryrun, lower_plan


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` fake ranks (this process is rank
    0) for the duration; refuses to replace a real group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; run "
                               "the dry-run in its own process")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def depth_unit(cfg) -> int:
    """Layers per group of the stack (see the module doc)."""
    if cfg.kind == "ssm":
        return cfg.slstm_every
    if cfg.kind == "hybrid":
        return cfg.attn_every
    return 1


def with_groups(cfg, g: int):
    """``cfg`` cut to ``g`` groups of its stack (an encoder-decoder keeps
    its encoder-to-decoder ratio)."""
    over = {"n_layers": g * depth_unit(cfg)}
    if cfg.kind == "encdec":
        over["n_enc_layers"] = cfg.n_enc_layers * g // cfg.n_layers
    return dataclasses.replace(cfg, **over)


def n_groups(cfg) -> int:
    g = cfg.n_layers // depth_unit(cfg)
    if cfg.kind == "encdec" and cfg.n_enc_layers % cfg.n_layers:
        return 0          # not proportional: trace the whole stack
    return g


def arg_bytes(plan) -> int:
    """Bytes of this rank's shards of every argument of the plan."""
    total = 0
    for x in tree_leaves(plan.args):
        if isinstance(x, DTensor):
            x = x.to_local()
        total += x.numel() * x.element_size()
    return total


def trace_stats(arch: str, shape: str, mesh, *, cfg,
                **kw) -> tuple[OpStats, str, dict]:
    """(per-device stats, mode, trace info) of one pair, depth-scaled
    where the stack has more than two groups."""
    g = n_groups(cfg)
    if g <= 2:
        plan = build_dryrun(arch, shape, mesh, cfg_override=cfg, **kw)
        _, st = count_ops(lower_plan, plan)
        return st, plan.mode, {"groups": g, "traced": [g]}
    stats = []
    for k in (1, 2):
        plan = build_dryrun(arch, shape, mesh,
                            cfg_override=with_groups(cfg, k), **kw)
        stats.append(count_ops(lower_plan, plan)[1])
    s1, s2 = stats
    total = s1.scaled_sum([(s2, g - 1), (s1, -(g - 1))])
    return total, plan.mode, {"groups": g, "traced": [1, 2]}


def run_pair(arch: str, shape: str, *, multi_pod: bool,
             verbose: bool = True, optimized: bool = False,
             mesh=None) -> dict:
    """One pair's record.  ``mesh``: the production mesh over a fake group
    already made (``main`` makes one per mesh shape), else one is made
    for this pair."""
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "optimized": optimized}
    if not supports_shape(arch, shape):
        rec["status"] = "skipped"
        rec["reason"] = "long_500k not applicable (DESIGN.md §4)"
        return rec
    t0 = time.time()
    try:
        with contextlib.ExitStack() as stack:
            if mesh is None:
                mesh = stack.enter_context(production_world(multi_pod))
            cfg = get_config(arch, shape=shape)
            full = build_dryrun(arch, shape, mesh, optimized=optimized)
            t_build = time.time() - t0
            st, mode, info = trace_stats(arch, shape, mesh, cfg=cfg,
                                         optimized=optimized)
        rec.update(
            status="ok",
            mode=mode,
            build_s=round(t_build, 1),
            trace=info,
            memory={"argument_bytes": arg_bytes(full), "peak_bytes": None},
            cost={"flops": st.flops, "bytes_accessed": st.bytes},
            collectives=st.collectives(),
            n_params=cfg.n_params(),
            n_active_params=cfg.n_active_params(),
        )
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    if verbose:
        mark = {"ok": "PASS", "fail": "FAIL", "skipped": "SKIP"}[rec["status"]]
        extra = ""
        if rec["status"] == "ok":
            extra = (f" args={rec['memory']['argument_bytes'] / 2**30:.2f}GiB"
                     f" flops={rec['cost']['flops']:.3e}"
                     f" coll={rec['collectives']['total_bytes'] / 2**30:.2f}"
                     "GiB")
        if rec["status"] == "fail":
            extra = " " + rec["error"][:160]
        print(f"[{mark}] {arch} x {shape} ({rec['mesh']}) "
              f"{rec['wall_s']}s{extra}", flush=True)
    return rec


@contextlib.contextmanager
def production_world(multi_pod: bool):
    """The production mesh over a fake group of its size."""
    shape, _ = production_layout(multi_pod)
    n = 1
    for d in shape:
        n *= d
    with fake_world(n):
        yield make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs x all shapes")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the §Perf sharding scheme (O1-O4)")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    records = []
    for mp in meshes:
        with production_world(mp) as mesh:
            for arch in archs:
                for shape in shapes:
                    rec = run_pair(arch, shape, multi_pod=mp,
                                   optimized=args.optimized, mesh=mesh)
                    records.append(rec)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_fail = sum(r["status"] == "fail" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"of {len(records)}")
    if n_fail:
        sys.exit(1)
    return records


if __name__ == "__main__":
    main()
