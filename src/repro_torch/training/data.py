"""Synthetic token data pipeline: deterministic, shardable, dependency-free.

Produces next-token-predictable streams (a mixture of ngram-Markov chains
and copy patterns) so a ~100M-param model visibly learns within a few
hundred steps — used by the end-to-end training example.  The pipeline is
an iterator of host numpy batches; the launcher shards them onto the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-chain order and determinism level of the synthetic language
    order: int = 2
    temperature: float = 0.35


class SyntheticLM:
    """Order-k Markov chain over the vocab with a sparse transition table."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # each context hashes to a row of 8 plausible next tokens
        self.n_rows = 8192
        self.table = rng.integers(0, v, size=(self.n_rows, 8))
        self.weights = rng.dirichlet(
            np.full(8, cfg.temperature), size=self.n_rows
        )

    def _ctx_hash(self, ctx: np.ndarray) -> np.ndarray:
        h = np.zeros(ctx.shape[0], np.int64)
        for k in range(ctx.shape[1]):
            h = h * 1000003 + ctx[:, k]
        return np.abs(h) % self.n_rows

    def sample_batch(self, rng: np.random.Generator, batch: int,
                     seq: int) -> np.ndarray:
        cfg = self.cfg
        out = np.zeros((batch, seq), np.int64)
        out[:, : cfg.order] = rng.integers(0, cfg.vocab,
                                           size=(batch, cfg.order))
        for t in range(cfg.order, seq):
            rows = self._ctx_hash(out[:, t - cfg.order : t])
            choices = self.table[rows]                      # (B, 8)
            w = self.weights[rows]
            cum = np.cumsum(w, axis=1)
            u = rng.random((batch, 1))
            idx = (u > cum).sum(axis=1)
            out[:, t] = choices[np.arange(batch), idx]
        return out.astype(np.int32)


def data_iterator(cfg: DataConfig) -> Iterator[dict]:
    lm = SyntheticLM(cfg)
    rng = np.random.default_rng(cfg.seed + 1)
    while True:
        yield {"tokens": lm.sample_batch(rng, cfg.global_batch, cfg.seq_len)}
