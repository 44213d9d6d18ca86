"""Training launcher of the port (the PyTorch counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        [--reduced | --no-reduced] [--steps 100] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --mesh debug --device cpu

``--reduced`` (the default, as in the JAX launcher) trains the smoke-scale
variant; ``--no-reduced`` trains the full config.  The model trains on
``--device`` (default: the CUDA card; with no device named and no CUDA
device the launcher raises).  ``--mesh none`` trains on one device;
``debug`` (``--mesh-shape``, default 2x2), ``prod`` (16x16) and
``multipod`` (2x16x16) train sharded, as the JAX launcher does: the
process group comes from the ``torchrun`` environment (gloo on the CPU,
NCCL on the cards; a group already initialised is used as it is), the
mesh must have as many ranks as the group, the parameters and the AdamW
moments are sharded by ``param_pspecs``/``opt_pspecs`` and the batch by
``train_batch_pspecs``, and each step runs under the mesh's rules.  Each
step's loss and grad norm are read back to the host, so the printed
seconds per step are the device's.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.training import (
    AdamWConfig,
    DataConfig,
    data_iterator,
    init_adamw,
    make_train_step,
    save_checkpoint,
)
from repro_torch.tree import tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--mesh", choices=["none", "debug", "prod", "multipod"],
                    default="none")
    ap.add_argument("--mesh-shape", default="2,2",
                    help="the debug mesh's (data, model) shape")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs there)")
    return ap.parse_args(argv)


def sharded_context(args, device: torch.device):
    """(mesh, device) of a ``--mesh`` other than ``none``: the process
    group from the ``torchrun`` environment where none is initialised, the
    rank's card where the device is CUDA, and the mesh, which must hold
    every rank."""
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                f"--mesh {args.mesh} needs a process group: start the "
                "launcher under torchrun (or initialise one first)")
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    shape = tuple(int(d) for d in args.mesh_shape.split(","))
    mesh = {
        "debug": lambda: make_debug_mesh(shape, device_type=device.type),
        "prod": lambda: make_production_mesh(device_type=device.type),
        "multipod": lambda: make_production_mesh(multi_pod=True,
                                                 device_type=device.type),
    }[args.mesh]()
    return mesh, device


def run(argv=None) -> list[dict]:
    """Train as the flags say; returns one record per step: ``loss``,
    ``grad_norm``, ``lr`` and the wall seconds since the start
    (``elapsed_s``).  Under a mesh every rank runs this and gets the same
    records; rank 0 prints."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh != "none":
        mesh, device = sharded_context(args, device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab=min(cfg.vocab, 512))
    model = Model(cfg, device=device)
    params = model.init(seed=0)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step = make_train_step(model, opt_cfg)
    data = data_iterator(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, order=1))
    ctx = contextlib.nullcontext()
    if mesh is not None:
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.launch.sharding import (
            make_rules,
            opt_pspecs,
            param_pspecs,
            train_batch_pspecs,
        )
        from repro_torch.launch.specs import distribute, distribute_tree
        from repro_torch.models.shardlib import use_sharding

        pspecs = param_pspecs(params, cfg, mesh)
        params = distribute_tree(params, mesh, pspecs)
        # moments made from the sharded parameters, laid out by opt_pspecs
        opt = distribute_tree(init_adamw(params), mesh, opt_pspecs(pspecs))
        bspecs = train_batch_pspecs(cfg, mesh)
        ctx = contextlib.ExitStack()
        ctx.enter_context(use_sharding(mesh, make_rules(cfg, mesh)))
        ctx.enter_context(implicit_replication())
    else:
        opt = init_adamw(params)
    verbose = mesh is None or dist.get_rank() == 0

    history = []
    t0 = time.time()
    with ctx:
        for i in range(args.steps):
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in next(data).items()}
            if mesh is not None:
                batch = {k: distribute(v, mesh, bspecs[k])
                         for k, v in batch.items()}
            params, opt, metrics = step(params, opt, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["elapsed_s"] = time.time() - t0
            history.append(rec)
            if verbose and (i % 10 == 0 or i == args.steps - 1):
                print(f"step {i:4d} loss={rec['loss']:.3f} "
                      f"({rec['elapsed_s'] / (i + 1):.2f}s/step)", flush=True)
    if args.ckpt:
        if mesh is not None:
            params = tree_map(lambda p: p.full_tensor(), params)
        if verbose:
            save_checkpoint(args.ckpt, {"params": params}, step=args.steps)
            print(f"saved {args.ckpt}")
    return history


if __name__ == "__main__":
    run()
