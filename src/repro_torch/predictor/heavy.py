"""Heavy single-model predictor baseline (Table 1's DistilBERT/S3 stand-in).

The port's counterpart of ``repro.predictor.heavy``: a small-from-scratch
transformer encoder regressor trained on the *pooled* corpus (one model for
every agent class — the S3 design the paper argues against).  No
pretrained weights exist offline, so this is a size/latency-faithful
substitute: it is two orders of magnitude more compute per prediction than
the MLP and lacks the per-class prior, which is exactly the comparison axis
of Table 1 (accuracy, inference overhead, JCT impact, training time).

Plain PyTorch at float32; the initial weights are draws from a CPU
``torch.Generator``, the same on every device, but not JAX's numbers
(parity tests bridge JAX's).  ``_hash_tokens`` hashes words with Python's
``hash()``, salted per process unless ``PYTHONHASHSEED`` is set, as the
JAX package does: token ids agree between the two packages only within
one process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.predictor.tfidf import tokenize
from repro_torch.tree import tree_leaves, tree_unflatten

VOCAB = 4096
MAX_LEN = 128


def _hash_tokens(prompt: str) -> np.ndarray:
    ids = [(hash(t) % (VOCAB - 2)) + 2 for t in tokenize(prompt)[:MAX_LEN]]
    out = np.zeros(MAX_LEN, np.int32)
    out[: len(ids)] = ids
    return out


def init_encoder_params(gen: torch.Generator, d: int = 256,
                        n_layers: int = 4, n_heads: int = 4, device=None):
    """Scaled normal draws, float32, moved to ``device``.  ``gen`` is a CPU
    generator, so a seed gives the same parameters on every device.
    ``n_heads`` is not a parameter's shape (JAX's signature)."""
    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    params = {
        "embed": normal((VOCAB, d), 0.02),
        "pos": normal((MAX_LEN, d), 0.02),
        "layers": [],
    }
    for _ in range(n_layers):
        params["layers"].append(
            {
                "wq": normal((d, d), d ** -0.5),
                "wk": normal((d, d), d ** -0.5),
                "wv": normal((d, d), d ** -0.5),
                "wo": normal((d, d), d ** -0.5),
                "w1": normal((d, 4 * d), d ** -0.5),
                "w2": normal((4 * d, d), (4 * d) ** -0.5),
            }
        )
    params["head"] = normal((d, 1), d ** -0.5)
    return params


N_HEADS = 4


def encoder_apply(params, ids, n_heads: int = N_HEADS):
    ids = ids.long()
    x = params["embed"][ids] + params["pos"][None, : ids.shape[1]]
    mask = (ids > 0)[..., None]
    for lyr in params["layers"]:
        b, s, d = x.shape
        hd = d // n_heads

        def split(h):
            return h.reshape(b, s, n_heads, hd).transpose(1, 2)

        q, k, v = split(x @ lyr["wq"]), split(x @ lyr["wk"]), split(x @ lyr["wv"])
        att = (q @ k.transpose(-1, -2)) / float(np.sqrt(hd))
        att = torch.softmax(att, dim=-1)
        o = (att @ v).transpose(1, 2).reshape(b, s, d)
        x = x + o @ lyr["wo"]
        # jax.nn.gelu's default is the tanh approximation
        x = x + F.gelu(x @ lyr["w1"], approximate="tanh") @ lyr["w2"]
        x = x * mask
    pooled = x.sum(1) / torch.clamp(mask.sum(1), min=1)
    return (pooled @ params["head"])[..., 0]


def _loss(params, ids, y):
    return torch.mean((encoder_apply(params, ids) - y) ** 2)


def _sgd_step(params, ids, y, lr):
    """One SGD step on the MSE; returns new parameters."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = _loss(tree_unflatten(params, leaves), ids, y)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves, grads)]
    return tree_unflatten(params, new)


@dataclasses.dataclass
class HeavyPredictor:
    params: dict

    @classmethod
    def train(
        cls,
        prompts: Sequence[str],
        costs: Sequence[float],
        *,
        seed: int = 0,
        epochs: int = 30,
        batch: int = 32,
        lr: float = 3e-4,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "HeavyPredictor":
        dev = resolve_device(device)
        ids = np.stack([_hash_tokens(p) for p in prompts])
        y = np.log1p(np.asarray(costs, np.float32))
        gen = torch.Generator().manual_seed(int(seed))
        params = init_encoder_params(gen, device=dev)
        rng = np.random.default_rng(seed)
        n = len(prompts)
        for _ in range(epochs):
            order = rng.permutation(n)
            for s in range(0, n, batch):
                idx = order[s : s + batch]
                params = _sgd_step(
                    params, torch.as_tensor(ids[idx], device=dev),
                    torch.as_tensor(y[idx], device=dev), lr,
                )
        return cls(params=params)

    def _log_costs(self, ids: np.ndarray) -> np.ndarray:
        dev = self.params["embed"].device
        with torch.no_grad():
            out = encoder_apply(self.params, torch.as_tensor(ids, device=dev))
        return out.cpu().numpy()

    def predict(self, prompt: str) -> float:
        logc = float(self._log_costs(_hash_tokens(prompt)[None])[0])
        return float(np.expm1(np.clip(logc, 0.0, 30.0)))

    def predict_batch(self, prompts: Sequence[str]) -> np.ndarray:
        logc = self._log_costs(np.stack([_hash_tokens(p) for p in prompts]))
        return np.expm1(np.clip(logc, 0.0, 30.0))
