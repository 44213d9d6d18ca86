"""Training launcher of the port (the PyTorch counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        [--reduced | --no-reduced] [--steps 100] [--device cpu]

``--reduced`` (the default, as in the JAX launcher) trains the smoke-scale
variant; ``--no-reduced`` trains the full config on one device.  The model
trains on ``--device`` (default: the CUDA card; with no device named and no
CUDA device the launcher raises).  Only ``--mesh none`` runs: the sharded
meshes of the JAX launcher wait for the port's distribution layer
(ROADMAP §1 item 3) and raise ``NotImplementedError``.  Each step's loss
and grad norm are read back to the host, so the printed seconds per step
are the device's.
"""

from __future__ import annotations

import argparse
import time

import torch

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
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs there)")
    return ap.parse_args(argv)


def run(argv=None) -> list[dict]:
    """Train as the flags say; returns one record per step: ``loss``,
    ``grad_norm``, ``lr`` and the wall seconds since the start
    (``elapsed_s``)."""
    args = parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device only; the "
            "sharded meshes wait for its distribution layer (ROADMAP §1 "
            "item 3)"
        )
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab=min(cfg.vocab, 512))
    model = Model(cfg, device=device)
    params = model.init(seed=0)
    opt = init_adamw(params)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step = make_train_step(model, opt_cfg)
    data = data_iterator(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, order=1))

    history = []
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        params, opt, metrics = step(params, opt, batch)
        rec = {k: float(v) for k, v in metrics.items()}
        rec["elapsed_s"] = time.time() - t0
        history.append(rec)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={rec['loss']:.3f} "
                  f"({rec['elapsed_s'] / (i + 1):.2f}s/step)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": params}, step=args.steps)
        print(f"saved {args.ckpt}")
    return history


if __name__ == "__main__":
    run()
