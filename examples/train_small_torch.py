"""Train a small LM for a few hundred steps on the synthetic pipeline, on
the port (the PyTorch counterpart of ``examples/train_small.py``).

    PYTHONPATH=src python examples/train_small_torch.py [--steps 200] \
        [--arch granite-3-2b] [--ckpt PATH] [--device cpu]

Uses the port's Model / ``make_train_step`` / AdamW / data / checkpoint
substrate at a small scale, on ``--device`` (the CUDA card unless another
device is named; with none named and no CUDA device it raises).  The step
runs eagerly (JAX jits it).  Loss should fall well below the uniform
baseline ln(vocab).  The checkpoint's bytes are the JAX package's format:
``repro.training.restore_checkpoint`` reads it.  The default ``--ckpt``
lies in the system's temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.training import (
    AdamWConfig,
    DataConfig,
    data_iterator,
    init_adamw,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)

VOCAB = 512


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt.msgpack"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs there)")
    return ap.parse_args(argv)


def build(args, device):
    """The model (parameters from seed 0), its AdamW state, the train step
    and the data iterator."""
    cfg = get_config(args.arch).reduced(
        vocab=VOCAB, n_layers=2, d_model=256, d_ff=512, n_heads=4,
        n_kv_heads=2, head_dim=64,
    )
    model = Model(cfg, device=device)
    params = model.init(seed=0)
    opt = init_adamw(params)
    step_fn = make_train_step(
        model, AdamWConfig(lr=3e-3, warmup_steps=20,
                           total_steps=args.steps, weight_decay=0.01)
    )
    data = data_iterator(DataConfig(vocab=VOCAB, seq_len=128,
                                    global_batch=8, order=1,
                                    temperature=0.25))
    return model, params, opt, step_fn, data


def train(args, device):
    """``args.steps`` steps, printed every 20; returns the parameters and
    the last step's metrics."""
    model, params, opt, step_fn, data = build(args, device)
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    return params, metrics


def main(argv=None):
    args = parse_args(argv)
    params, metrics = train(args, resolve_device(args.device))
    uniform = float(np.log(VOCAB))
    final = float(metrics["loss"])
    print(f"final loss {final:.3f} vs uniform {uniform:.3f}")
    save_checkpoint(args.ckpt, {"params": params}, step=args.steps)
    restored, st = restore_checkpoint(args.ckpt, {"params": params})
    print(f"checkpoint round-trip OK at step {st} -> {args.ckpt}")


if __name__ == "__main__":
    main()
