"""Model configuration for the assigned architecture pool.

One ``ModelConfig`` describes any architecture the framework can build:
dense GQA transformers, SWA variants, MoE, encoder-decoder (audio), VLM
decoders, xLSTM stacks, and Mamba2+attention hybrids.  Every assigned
architecture in ``repro/configs/`` instantiates this dataclass with the
exact numbers from its source paper / model card.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Block(enum.Enum):
    """Sequence-mixing block kinds a layer stack can be built from."""

    ATTN = "attn"          # (GQA) attention, optionally sliding-window
    MLSTM = "mlstm"        # xLSTM matrix-memory block
    SLSTM = "slstm"        # xLSTM scalar-memory block
    MAMBA2 = "mamba2"      # Mamba2 SSD block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 500_000.0
    use_rope: bool = True          # False -> learned absolute positions
    sliding_window: int = 0        # 0 -> full attention
    max_position: int = 1_048_576  # for learned positions / rope cache

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0             # Mamba2 state size per head
    conv_width: int = 4            # Mamba2 short conv
    attn_every: int = 0            # hybrid: one shared attn block every k
    # xLSTM: ratio of mLSTM blocks per sLSTM block (7:1 in the paper's
    # xLSTM[7:1]; we alternate per `slstm_every`)
    slstm_every: int = 2

    # encoder-decoder (audio)
    n_enc_layers: int = 0
    n_audio_frames: int = 1500     # whisper 30 s @ 50 Hz after conv stub

    # VLM
    n_image_tokens: int = 0        # anyres patch embeddings (stub frontend)

    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # distribution policy (resolved per-arch; see DESIGN.md §5)
    # "heads"    -> shard attention over the head axis
    # "head_dim" -> shard attention over the per-head feature axis
    attn_shard: str = "auto"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # ---------------------------------------------------------------- props

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_shard_mode(self, model_par: int) -> str:
        """Resolve 'auto' against a model-parallel degree."""
        if self.attn_shard != "auto":
            return self.attn_shard
        return "heads" if self.n_heads % model_par == 0 else "head_dim"

    def n_params(self) -> int:
        """Approximate parameter count (reporting/roofline only)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * hd * nh + 2 * d * hd * nkv + hd * nh * d
        if self.is_moe:
            ffn = self.n_experts * 3 * d * f
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        total = self.n_layers * per_layer + v * d * (1 if self.tie_embeddings else 2)
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + ffn + 2 * d)
        return int(total)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_ffn = self.n_layers * 3 * d * f
        total = self.n_params() - self.n_layers * self.n_experts * 3 * d * f
        return int(total + self.top_k * dense_ffn)

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (CPU-runnable)."""
        small = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_audio_frames=16 if self.n_enc_layers else 1500,
            n_image_tokens=8 if self.n_image_tokens else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window
            else 0,
            max_position=4096,
            dtype="float32",
            name=self.name + "-smoke",
        )
        # keep kv heads consistent with heads
        if small["n_heads"] % small["n_kv_heads"]:
            small["n_kv_heads"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
