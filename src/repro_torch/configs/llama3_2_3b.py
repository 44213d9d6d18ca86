"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B family].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, RoPE theta 500k.
24 heads % 16 model-parallel != 0 -> head_dim sharding (DESIGN.md §5).
long_500k uses the sliding-window decode variant (ring buffer 8192) — the
honest sub-quadratic mechanism for a full-attention dense arch (DESIGN §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    kind="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
)

# selected only by the long_500k input shape
LONG_CONTEXT_OVERRIDES = {"sliding_window": 8192}
