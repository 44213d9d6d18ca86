"""Per-agent-type cost predictor: 4-layer MLP in plain PyTorch (paper §4.2).

The port's counterpart of ``repro.predictor.mlp``, with the same names and
behaviour at float32.  One model per agent class (the agent type is the
prior that makes prediction accurate — App. A's demand stability).
Trained on ~100 samples with MSE + L2 via a hand-written Adam; the first
hidden width is proportional to the input feature width, mirroring the
paper's "number of neurons in the first layer is proportional to the
average agent input size".

Targets are log-transformed: agent KV token-time spans ~4 orders of
magnitude across classes, and relative (not absolute) error is what the
scheduler cares about.

The initial weights are He-normal draws from a CPU ``torch.Generator``,
the same on every device, but not JAX's numbers (parity tests bridge
JAX's).  Adam divides by ``sqrt(v_hat) + 1e-8``, which magnifies one-ulp
differences in near-zero gradients, so a whole ``MlpCostModel.train``
follows the JAX trajectory only to a tolerance, not step for step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_mlp_params(gen: torch.Generator, in_dim: int, widths: Sequence[int],
                    device=None) -> list[dict]:
    """He-normal weights and zero biases, float32, moved to ``device``.
    ``gen`` is a CPU generator: a seed gives the same initial parameters on
    every device, so a fit on the card and one on the CPU differ only by
    rounding."""
    params = []
    dims = [in_dim, *widths, 1]
    for a, b in zip(dims, dims[1:]):
        params.append(
            {
                "w": (torch.randn((a, b), generator=gen)
                      * float(np.sqrt(2.0 / a))).to(device),
                "b": torch.zeros((b,), dtype=torch.float32, device=device),
            }
        )
    return params


def mlp_apply(params, x):
    h = x
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    out = h @ params[-1]["w"] + params[-1]["b"]
    return out[..., 0]


def _loss(params, x, y, l2: float):
    pred = mlp_apply(params, x)
    mse = torch.mean((pred - y) ** 2)
    reg = sum(torch.sum(p["w"] ** 2) for p in params)
    return mse + l2 * reg


def _adam_step(params, opt_state, x, y, step, lr: float, l2: float):
    """One Adam step on ``_loss`` (b1 0.9, b2 0.999, eps 1e-8, bias
    correction by ``step``, L2 on the weights only); returns the new
    ``(params, (m, v))``, each a list like ``params``.  Gradients come from
    ``torch.autograd.grad``; ``torch.optim.Adam`` would add eps elsewhere."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = _loss(tree_unflatten(params, leaves), x, y, l2)
    grads = torch.autograd.grad(loss, leaves)
    m, v = (tree_leaves(s) for s in opt_state)
    # the bias corrections in float32, as JAX computes b ** step
    f32 = dict(dtype=torch.float32, device=x.device)
    step_f = torch.tensor(float(step), **f32)
    bc1 = 1 - torch.tensor(b1, **f32) ** step_f
    bc2 = 1 - torch.tensor(b2, **f32) ** step_f
    with torch.no_grad():
        m = [b1 * m_ + (1 - b1) * g for m_, g in zip(m, grads)]
        v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(v, grads)]
        new = [p - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
               for p, m_, v_ in zip(tree_leaves(params), m, v)]
    return (tree_unflatten(params, new),
            (tree_unflatten(params, m), tree_unflatten(params, v)))


@dataclasses.dataclass
class MlpCostModel:
    """log-cost regressor for one agent class.

    Predictions are clipped to the (slightly widened) range of the training
    targets: App. A's *demand stability* means an agent class's cost lives in
    a narrow band across runs, so out-of-band extrapolations of a small MLP
    are never trusted.  With the log-space target this also bounds the worst
    multiplicative error — which is the robustness knob Fig. 10 studies.

    ``params`` stay on the device the model was trained on.
    """

    params: list[dict]
    x_mean: np.ndarray
    x_std: np.ndarray
    y_mean: float
    y_lo: float
    y_hi: float

    @classmethod
    def train(
        cls,
        x: np.ndarray,
        cost: np.ndarray,
        *,
        seed: int = 0,
        epochs: int = 800,
        lr: float = 3e-3,
        l2: float = 3e-4,
        width_factor: float = 1.0,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "MlpCostModel":
        dev = resolve_device(device)
        x = np.asarray(x, np.float32)
        y = np.log1p(np.asarray(cost, np.float32))
        # center the target: a ReLU net initialized near zero should learn
        # the *deviation* from the class-mean log cost, not the ~e^12 scale
        y_mean = float(y.mean())
        y = y - y_mean
        x_mean = x.mean(axis=0)
        # floor the scale: near-constant training features must not explode
        # on unseen inputs (a word seen once in training has std ~0)
        x_std = np.maximum(x.std(axis=0), 1e-2)
        xn = (x - x_mean) / x_std
        in_dim = x.shape[1]
        # 4-layer MLP; first width proportional to the input size (paper)
        w1 = max(16, int(in_dim * width_factor))
        widths = [w1, max(8, w1 // 2), max(8, w1 // 4)]
        gen = torch.Generator().manual_seed(int(seed))
        params = init_mlp_params(gen, in_dim, widths, dev)
        opt_state = tuple(tree_map(torch.zeros_like, params)
                          for _ in range(2))
        # 80/20 train/validation split with early stopping: with ~100
        # samples a small MLP memorizes quickly; the val split picks the
        # epoch with the best generalization (then we keep those weights)
        n = xn.shape[0]
        perm = np.random.default_rng(seed).permutation(n)
        n_val = max(1, n // 5)
        vi, ti = perm[:n_val], perm[n_val:]

        def to_dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        xj, yj = to_dev(xn[ti]), to_dev(y[ti])
        xv, yv = to_dev(xn[vi]), to_dev(y[vi])
        best_val, best_params, since_best = np.inf, params, 0
        for step in range(1, epochs + 1):
            params, opt_state = _adam_step(
                params, opt_state, xj, yj, step, lr, l2
            )
            if step % 5 == 0:
                with torch.no_grad():
                    val = float(torch.mean((mlp_apply(params, xv) - yv) ** 2))
                if val < best_val - 1e-5:
                    best_val, best_params, since_best = val, params, 0
                else:
                    since_best += 5
                    if since_best >= 60:
                        break
        params = best_params
        margin = 0.25  # ~ +/- 28% beyond the observed band
        return cls(
            params=params,
            x_mean=x_mean,
            x_std=x_std,
            y_mean=y_mean,
            y_lo=float(y.min() + y_mean - margin),
            y_hi=float(y.max() + y_mean + margin),
        )

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = (np.asarray(x, np.float32) - self.x_mean) / self.x_std
        dev = self.params[0]["w"].device
        with torch.no_grad():
            out = mlp_apply(self.params, torch.as_tensor(x, device=dev))
        logc = out.cpu().numpy() + self.y_mean
        return np.expm1(np.clip(logc, self.y_lo, self.y_hi))
