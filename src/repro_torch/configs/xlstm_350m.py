"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 (no separate FFN; the xLSTM block is the mixer)
vocab=50304.  Layers alternate mLSTM/sLSTM (slstm_every=2 -> 12 pairs).
Recurrent state is O(1) per sequence: long_500k runs natively, and the
paper's memory-centric cost model degenerates to linear (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    kind="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=2,   # recurrence encodes position; no pos table / rope used
)

LONG_CONTEXT_OVERRIDES = {}  # native O(1) state
