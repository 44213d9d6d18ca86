"""Operations and bytes of the attention kernels and of a whole model step,
from shapes and lengths, and the least time the card could take for them.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense):
989e12 bf16 FLOP/s and 3.35e12 B/s, the peaks the port's ``chip_smoke.py``
states.  The byte and operation counts of a kernel call are those of
``chip_smoke.py``'s ``time_paged`` and ``time_flash`` (each input byte read
once, each output byte written once), taken over the lengths the call
really serves rather than a full or padded tile.
"""

from __future__ import annotations

from typing import Iterable, Sequence

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time of a call: the larger of its bytes over the
    bandwidth and its operations over the bf16 peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_BF16)


def causal_pairs(n: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask, and a sliding window of ``window``
    keys, leave in a sequence of n tokens: sum_i min(i + 1, window)."""
    n, w = int(n), int(window)
    if n <= 0:
        return 0
    if not w or w >= n:
        return n * (n + 1) // 2
    return w * (w + 1) // 2 + (n - w) * w


def paged_call(lengths: Sequence[int], nh: int, n_kv: int, hd: int,
               max_pages: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one paged-decode call: every row's K and V over
    its length read once, its query read and its output written once, and
    the block table and lengths read (int32)."""
    b = len(lengths)
    n_tok = int(sum(int(x) for x in lengths))
    n_bytes = (2 * n_tok * n_kv * hd * BF16_BYTES
               + 2 * b * nh * hd * BF16_BYTES
               + b * int(max_pages) * 4 + b * 4)
    flops = 2 * 2 * n_tok * nh * hd
    return float(n_bytes), float(flops)


def flash_call(lens: Iterable[int], nh: int, n_kv: int, hd: int,
               window: int = 0) -> tuple[float, float]:
    """(bytes, FLOPs) of one causal flash-prefill call over rows of the
    real lengths ``lens`` (padding rows and padded tails left out): q, k
    and v read once and the output written once, and two products over
    the (query, key) pairs the mask and window leave."""
    n_bytes, flops = 0, 0
    for n in lens:
        n = int(n)
        n_bytes += BF16_BYTES * (2 * n * nh * hd + 2 * n * n_kv * hd)
        flops += 2 * 2 * nh * hd * causal_pairs(n, window)
    return float(n_bytes), float(flops)


def dense_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies through in one layer of the dense
    GQA block: q, k, v and o projections and the gated MLP."""
    d, f = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    nh, n_kv = int(cfg["num_attention_heads"]), int(
        cfg["num_key_value_heads"])
    hd = d // nh
    return d * nh * hd + 2 * d * n_kv * hd + nh * hd * d + 3 * d * f


def _attn_dims(cfg: dict) -> tuple[int, int, int]:
    d, nh = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return int(cfg["num_hidden_layers"]), nh, d // nh


def prefill_flops(cfg: dict, n: int) -> float:
    """Useful FLOPs of prefilling one n-token prompt: every token through
    every layer's products, the causal attention, and one row of logits
    (the engine computes the last position's only)."""
    layers, nh, hd = _attn_dims(cfg)
    window = int(cfg.get("sliding_window") or 0)
    vocab, d = int(cfg["vocab_size"]), int(cfg["hidden_size"])
    return float(layers * (2 * dense_matmul_params(cfg) * n
                           + 4 * nh * hd * causal_pairs(n, window))
                 + 2 * d * vocab)


def decode_flops(cfg: dict, context: int) -> float:
    """Useful FLOPs of one decode token attending over ``context`` keys
    (itself included): the layers' products, attention and the logits."""
    layers, nh, hd = _attn_dims(cfg)
    window = int(cfg.get("sliding_window") or 0)
    keys = min(int(context), window) if window else int(context)
    vocab, d = int(cfg["vocab_size"]), int(cfg["hidden_size"])
    return float(layers * (2 * dense_matmul_params(cfg) + 4 * nh * hd * keys)
                 + 2 * d * vocab)
