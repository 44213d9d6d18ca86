"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
36 heads % 16 != 0 -> head_dim sharding.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    kind="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    rope_theta=1_000_000.0,
)

LONG_CONTEXT_OVERRIDES = {"sliding_window": 8192}
