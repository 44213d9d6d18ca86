"""MLP-based agent demand prediction (paper §4.2) + heavy baseline: the
port's counterpart of ``repro.predictor``, in plain PyTorch."""

from repro_torch.predictor.heavy import HeavyPredictor
from repro_torch.predictor.mlp import MlpCostModel, init_mlp_params, mlp_apply
from repro_torch.predictor.service import (
    AgentCostPredictor,
    TrainedClassModel,
    relative_error,
)
from repro_torch.predictor.tfidf import TfidfVectorizer, tokenize

__all__ = [
    "HeavyPredictor",
    "MlpCostModel",
    "init_mlp_params",
    "mlp_apply",
    "AgentCostPredictor",
    "TrainedClassModel",
    "relative_error",
    "TfidfVectorizer",
    "tokenize",
]
