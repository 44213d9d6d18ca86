"""llama2-7b [dense] — the paper's own testbed model (Touvron et al. 2023),
kept as an eleventh config so the paper's serving experiments (Fig. 3/7)
have their exact backend architecture available.

32L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=32000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    kind="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=32000,
    rope_theta=10_000.0,
)

LONG_CONTEXT_OVERRIDES = {"sliding_window": 8192}
