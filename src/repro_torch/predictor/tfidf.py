"""TF-IDF vectorizer (Sparck Jones, 1972) — from scratch, scipy/sklearn-free.

The paper (§4.2) vectorizes the runtime input prompt with TF-IDF before the
per-agent-type MLP: "lightweight and efficient ... focusing on word
importance rather than deep semantic analysis".
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


@dataclasses.dataclass
class TfidfVectorizer:
    """Fit on a corpus; transform to dense (n, vocab) float32 features.

    ``max_features`` keeps the most document-frequent terms — bounded input
    width keeps the MLP's first layer small (the paper sizes it to the
    average agent input).  An extra feature column carries the normalized
    prompt length, which for LLM cost prediction is signal, not nuisance.
    """

    max_features: int = 256
    min_df: int = 3              # drop near-hapax terms (pure noise for cost)
    add_length_feature: bool = True

    vocab_: dict[str, int] | None = None
    idf_: np.ndarray | None = None
    len_scale_: float = 1.0

    def fit(self, corpus: Sequence[str]) -> "TfidfVectorizer":
        df: dict[str, int] = {}
        lengths = []
        for doc in corpus:
            toks = set(tokenize(doc))
            lengths.append(len(tokenize(doc)))
            for t in toks:
                df[t] = df.get(t, 0) + 1
        kept = {t: c for t, c in df.items() if c >= self.min_df}
        top = sorted(kept.items(), key=lambda kv: (-kv[1], kv[0]))[: self.max_features]
        self.vocab_ = {t: i for i, (t, _) in enumerate(top)}
        n = max(1, len(corpus))
        self.idf_ = np.array(
            [math.log((1 + n) / (1 + kept[t])) + 1.0 for t, _ in top],
            dtype=np.float32,
        )
        self.len_scale_ = float(max(1.0, np.mean(lengths))) if lengths else 1.0
        return self

    @property
    def dim(self) -> int:
        assert self.vocab_ is not None, "fit first"
        return len(self.vocab_) + (1 if self.add_length_feature else 0)

    def transform(self, corpus: Sequence[str]) -> np.ndarray:
        assert self.vocab_ is not None and self.idf_ is not None, "fit first"
        out = np.zeros((len(corpus), self.dim), dtype=np.float32)
        for r, doc in enumerate(corpus):
            toks = tokenize(doc)
            if not toks:
                continue
            counts: dict[int, int] = {}
            for t in toks:
                j = self.vocab_.get(t)
                if j is not None:
                    counts[j] = counts.get(j, 0) + 1
            for j, c in counts.items():
                out[r, j] = (c / len(toks)) * self.idf_[j]
            # L2 normalize the tf-idf block
            block = out[r, : len(self.vocab_)]
            nrm = float(np.linalg.norm(block))
            if nrm > 0:
                out[r, : len(self.vocab_)] = block / nrm
            if self.add_length_feature:
                out[r, -1] = len(toks) / self.len_scale_
        return out

    def fit_transform(self, corpus: Sequence[str]) -> np.ndarray:
        return self.fit(corpus).transform(corpus)

    # -- msgpack-able state for checkpointing --------------------------------

    def state_dict(self) -> dict:
        assert self.vocab_ is not None and self.idf_ is not None
        return {
            "max_features": self.max_features,
            "add_length_feature": self.add_length_feature,
            "vocab": list(self.vocab_.keys()),
            "idf": self.idf_.tolist(),
            "len_scale": self.len_scale_,
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "TfidfVectorizer":
        v = cls(
            max_features=d["max_features"],
            add_length_feature=d["add_length_feature"],
        )
        v.vocab_ = {t: i for i, t in enumerate(d["vocab"])}
        v.idf_ = np.asarray(d["idf"], dtype=np.float32)
        v.len_scale_ = float(d["len_scale"])
        return v
