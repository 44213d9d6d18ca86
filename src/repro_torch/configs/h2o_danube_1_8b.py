"""h2o-danube-1.8b [dense] — llama+mistral mix with native sliding-window
attention [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
Native SWA: long_500k runs with the arch's own window (ring-buffer cache).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    kind="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    rope_theta=10_000.0,
    sliding_window=4096,
)

LONG_CONTEXT_OVERRIDES = {}  # native SWA already sub-quadratic
