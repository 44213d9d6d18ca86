"""The operation and byte counts of ``roofline.py`` against hand-worked
cases, two of them the bounds ``chip_smoke.py`` prints for the same shapes
(PERF.md's kernel table)."""

from __future__ import annotations

import pytest

import roofline

#: a tiny dense configuration: 8 wide, 2 heads of 4 over 1 kv head, 2
#: layers, a 16-wide MLP, 10 tokens of vocabulary
TINY = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 1,
        "vocab_size": 10}


def test_paged_bound_at_granite_decode_is_chip_smokes():
    # B 8 slots of 512 tokens, 32 pages of 16, nh 32, n_kv 8, hd 64: K and V
    # 8,388,608 B, q and out 65,536 B, tables 1,024 B and lengths 32 B
    n_bytes, flops = roofline.paged_call([512] * 8, 32, 8, 64, 32)
    assert n_bytes == 8_388_608 + 65_536 + 1_024 + 32
    assert flops == 4 * 4096 * 32 * 64
    assert round(roofline.bound_s(n_bytes, flops) * 1e3, 4) == 0.0025


def test_flash_bound_at_h2o_danube_windowed_prefill_is_chip_smokes():
    # B 2 x 4,608 tokens, window 4,096, nh 32, n_kv 8, hd 80: bound by the
    # operations over 4,096 * 4,097 / 2 + 512 * 4,096 pairs a row
    n_bytes, flops = roofline.flash_call([4608, 4608], 32, 8, 80, 4096)
    pairs = 4096 * 4097 // 2 + 512 * 4096
    assert flops == 2 * 4 * 32 * 80 * pairs
    assert n_bytes == 2 * 2 * (2 * 4608 * 32 * 80 + 2 * 4608 * 8 * 80)
    assert round(roofline.bound_s(n_bytes, flops) * 1e3, 4) == 0.2172


@pytest.mark.parametrize("n,window,pairs", [
    (0, 0, 0), (1, 0, 1), (4, 0, 10), (5, 2, 9), (5, 5, 15), (5, 9, 15)])
def test_causal_pairs(n, window, pairs):
    assert roofline.causal_pairs(n, window) == pairs


def test_flash_counts_only_real_rows_and_lengths():
    one = roofline.flash_call([100], 4, 2, 64)
    assert roofline.flash_call([100, 0], 4, 2, 64) == one
    assert roofline.flash_call([100, 100], 4, 2, 64) == (2 * one[0],
                                                          2 * one[1])


def test_model_step_flops_by_hand():
    # per layer: q 8*2*4 + k, v 2*8*1*4 + o 2*4*8 + MLP 3*8*16 = 576 weights
    assert roofline.dense_matmul_params(TINY) == 576
    # one decode token over 3 keys: 2 layers x (2 * 576 + 4 * 2 * 4 * 3),
    # plus one row of logits, 2 * 8 * 10
    assert roofline.decode_flops(TINY, 3) == 2 * (1152 + 96) + 160
    # a 3-token prompt: 2 layers x (2 * 576 * 3 + 4 * 2 * 4 * 6 pairs),
    # plus the last position's logits
    assert roofline.prefill_flops(TINY, 3) == 2 * (3456 + 192) + 160
    windowed = {**TINY, "sliding_window": 2}
    assert roofline.decode_flops(windowed, 3) == 2 * (1152 + 64) + 160
    assert roofline.prefill_flops(windowed, 3) == 2 * (3456 + 160) + 160
