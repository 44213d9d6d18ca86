"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2,
sliding window 4096 (Mixtral v0.1 card).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    kind="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
)

LONG_CONTEXT_OVERRIDES = {}  # native SWA
