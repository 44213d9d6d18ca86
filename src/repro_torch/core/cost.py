"""Memory-centric cost modeling (paper §4.1).

The serving cost of an LLM inference is its cumulative KV-cache occupation
over the decode iterations — "KV token-time":

    c = sum_{i=1..d} (p + i) = p*d + d*(d+1)/2

with ``p`` the prefill (prompt) token length and ``d`` the decode (output)
token length.  The paper quotes the continuous approximation ``pd + d^2/2``;
we use the exact discrete sum everywhere (the difference, ``d/2``, never
changes an ordering decision but exactness makes the property tests crisp).

Units: KV-token-time is measured in (tokens x iterations).  Per the paper's
footnote 1, one "token" of KV here means the KV blocks for one token across
all layers/heads — a model-independent unit, which is what makes the cost
model transfer from GPU to TPU unchanged (see DESIGN.md §3).

Beyond the paper's dense formula we provide the family-adapted variants used
for the assigned architecture pool (DESIGN.md §4): sliding-window attention
(occupation saturates at the window), pure-SSM (constant state), hybrid, and
encoder-decoder (constant cross-attention occupation).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence


class MemoryFamily(enum.Enum):
    """How an architecture family occupies sequence memory during decode."""

    DENSE = "dense"            # full-attention KV cache, grows by 1/token
    SLIDING_WINDOW = "swa"     # KV ring buffer, saturates at window W
    SSM = "ssm"                # constant-size recurrent state
    HYBRID = "hybrid"          # mamba state + a fraction of attn layers
    ENCDEC = "encdec"          # decoder KV grows + constant cross-attn KV


@dataclasses.dataclass(frozen=True)
class InferenceSpec:
    """One LLM inference task inside an agent.

    ``stage`` encodes task-graph ordering inside an agent: stage-k inferences
    are submitted only once every stage-(k-1) inference completed (e.g. the
    merge step of MapReduce-Summarization).  Stage 0 tasks are submitted at
    agent arrival — the "task-parallel" case of the paper.
    """

    prefill: int
    decode: int
    stage: int = 0

    def __post_init__(self) -> None:
        if self.prefill < 0 or self.decode < 0:
            raise ValueError("prefill/decode must be non-negative")


def kv_token_time(prefill: int, decode: int) -> float:
    """Paper Eq. (1), exact discrete form: sum_{i=1..d} (p+i)."""
    p, d = float(prefill), float(decode)
    return p * d + d * (d + 1.0) / 2.0


def swa_kv_token_time(prefill: int, decode: int, window: int) -> float:
    """KV token-time when occupation saturates at a sliding window W.

    c = sum_{i=1..d} min(p+i, W).  Closed form by splitting at the
    saturation iteration i* = max(0, W - p).
    """
    if window <= 0:
        raise ValueError("window must be positive")
    p, d, w = prefill, decode, window
    if p >= w:  # already saturated at iteration 1
        return float(w) * d
    grow = min(d, w - p)  # iterations during which occupation still grows
    c_grow = kv_token_time(p, grow)
    c_flat = float(w) * max(0, d - grow)
    return c_grow + c_flat


def ssm_token_time(decode: int, state_tokens: float) -> float:
    """Constant recurrent state occupying ``state_tokens`` KV-token units."""
    return state_tokens * decode


def hybrid_kv_token_time(
    prefill: int, decode: int, attn_fraction: float, state_tokens: float
) -> float:
    """Mamba-state + shared-attention mix (e.g. zamba2)."""
    return (
        attn_fraction * kv_token_time(prefill, decode)
        + ssm_token_time(decode, state_tokens)
    )


def encdec_kv_token_time(prefill_enc: int, prefill_dec: int, decode: int) -> float:
    """Decoder self-attn KV grows; encoder-output cross-attn KV is constant."""
    return kv_token_time(prefill_dec, decode) + float(prefill_enc) * decode


def inference_cost(
    spec: InferenceSpec,
    family: MemoryFamily = MemoryFamily.DENSE,
    *,
    window: int = 0,
    state_tokens: float = 0.0,
    attn_fraction: float = 1.0,
    prefill_enc: int = 0,
) -> float:
    """KV token-time of one inference under the arch family's memory model."""
    if family is MemoryFamily.DENSE:
        return kv_token_time(spec.prefill, spec.decode)
    if family is MemoryFamily.SLIDING_WINDOW:
        return swa_kv_token_time(spec.prefill, spec.decode, window)
    if family is MemoryFamily.SSM:
        return ssm_token_time(spec.decode, state_tokens)
    if family is MemoryFamily.HYBRID:
        return hybrid_kv_token_time(
            spec.prefill, spec.decode, attn_fraction, state_tokens
        )
    if family is MemoryFamily.ENCDEC:
        return encdec_kv_token_time(prefill_enc, spec.prefill, spec.decode)
    raise ValueError(f"unknown family {family}")


def agent_cost(
    specs: Sequence[InferenceSpec],
    family: MemoryFamily = MemoryFamily.DENSE,
    **kwargs,
) -> float:
    """Paper §4.1: agent cost = sum of the KV token-time of its inferences."""
    return float(sum(inference_cost(s, family, **kwargs) for s in specs))


# --- Compute-centric baseline cost model (VTC, used by the Justitia/C
# --- ablation and by the VTC scheduler's service counter).

def vtc_cost(prefill: int, decode: int, w_p: float = 1.0, w_d: float = 2.0) -> float:
    """VTC's weighted token count: w_p * p + w_d * d (Sheng et al., 2024)."""
    return w_p * prefill + w_d * decode


def vtc_agent_cost(specs: Sequence[InferenceSpec]) -> float:
    return float(sum(vtc_cost(s.prefill, s.decode) for s in specs))
