"""llava-next-34b [vlm] — anyres tiling, ViT frontend stubbed
[hf:llava-hf/llava-v1.6-mistral-7b-hf family scaled to 34B].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision encoder
+ projector are a stub per the assignment carve-out: input_specs() provides
anyres patch embeddings (B, 2880, 7168) prepended to the text tokens.
56 heads % 16 != 0 -> head_dim sharding.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    kind="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=5_000_000.0,
    n_image_tokens=2880,   # anyres: base 576 + 4 tiles x 576
)

LONG_CONTEXT_OVERRIDES = {"sliding_window": 8192}
