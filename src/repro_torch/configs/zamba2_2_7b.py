"""zamba2-2.7b [hybrid] — Mamba2 backbone + one SHARED attention block
applied every 6 layers [arXiv:2411.15242].

54L d_model=2560 32H (kv=32, MHA in the shared block) d_ff=10240
vocab=32000, ssm_state=64.  54 = 9 super-blocks x 6 mamba2 layers; the
shared attention+MLP block's weights are reused at each application
(Zamba's parameter-sharing trick), each application keeping its own KV
cache.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    kind="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    rope_theta=10_000.0,
    ssm_state=64,
    attn_every=6,
)

LONG_CONTEXT_OVERRIDES = {}  # mamba state is O(1); attn KV sharded over seq
