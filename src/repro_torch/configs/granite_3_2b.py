"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
32 heads divisible by 16 -> head sharding.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    kind="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

LONG_CONTEXT_OVERRIDES = {"sliding_window": 8192}
