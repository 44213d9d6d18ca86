"""whisper-tiny [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

4L d_model=384 6H (kv=6, MHA) d_ff=1536 vocab=51865.  The mel+conv frontend
is a stub per the assignment carve-out: input_specs() supplies precomputed
frame embeddings (B, 1500, 384).  Whisper uses learned absolute positions
(use_rope=False); max_position is stretched to cover the assigned 32k
shapes (the model card caps decode at 448 — noted in DESIGN.md).
long_500k: SKIPPED (full-attention enc-dec; no long-context variant).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    kind="encdec",
    n_layers=4,            # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    use_rope=False,
    max_position=32_776,
    n_audio_frames=1500,
)

LONG_CONTEXT_OVERRIDES = None  # long_500k not applicable (DESIGN.md §4)
