"""Agent cost prediction service (paper §4.2 + Fig. 5 workflow).

One (TF-IDF vectorizer, 4-layer MLP) pair per agent class, trained on ~100
historical samples per class.  ``predict(class_name, prompt)`` is the
runtime path invoked at agent arrival — a few matrix-vector products, ~ms.

Also provides the Table-1 baseline: a single *heavy* transformer-encoder
regressor trained on the pooled corpus (the offline stand-in for the
DistilBERT/S3 approach — one big semantic model for all classes; see
DESIGN.md §7 for the substitution note).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.predictor.mlp import MlpCostModel
from repro_torch.predictor.tfidf import TfidfVectorizer


@dataclasses.dataclass
class TrainedClassModel:
    vectorizer: TfidfVectorizer
    model: MlpCostModel
    train_time_s: float


class AgentCostPredictor:
    """Per-agent-type MLP predictor (the paper's design).

    The MLPs train and predict on ``device`` (``cuda`` unless one is
    named)."""

    def __init__(self, max_features: int = 192,
                 device: Optional[Union[str, torch.device]] = None):
        self.max_features = max_features
        self.device = resolve_device(device)
        self.models: dict[str, TrainedClassModel] = {}

    def fit(
        self,
        samples: dict[str, tuple[Sequence[str], Sequence[float]]],
        *,
        seed: int = 0,
        epochs: int = 800,
    ) -> None:
        """samples: class_name -> (prompts, true agent costs)."""
        for cls_name, (prompts, costs) in samples.items():
            t0 = time.perf_counter()
            vec = TfidfVectorizer(max_features=self.max_features)
            x = vec.fit_transform(list(prompts))
            model = MlpCostModel.train(
                x, np.asarray(costs, np.float64), seed=seed, epochs=epochs,
                device=self.device,
            )
            self.models[cls_name] = TrainedClassModel(
                vectorizer=vec,
                model=model,
                train_time_s=time.perf_counter() - t0,
            )

    def predict(self, cls_name: str, prompt: str) -> float:
        m = self.models[cls_name]
        x = m.vectorizer.transform([prompt])
        return float(m.model.predict(x)[0])

    def predict_batch(self, cls_name: str, prompts: Sequence[str]) -> np.ndarray:
        m = self.models[cls_name]
        return m.model.predict(m.vectorizer.transform(list(prompts)))

    @property
    def total_train_time_s(self) -> float:
        return sum(m.train_time_s for m in self.models.values())


def relative_error(pred: np.ndarray, truth: np.ndarray) -> float:
    """Paper's metric: |pred − truth| / truth, averaged (as a percentage)."""
    pred = np.asarray(pred, np.float64)
    truth = np.asarray(truth, np.float64)
    return float(np.mean(np.abs(pred - truth) / np.maximum(truth, 1e-9)) * 100)
