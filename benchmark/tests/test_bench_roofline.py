"""The operation counts of the roofline and MFU metrics against hand counts
at two shapes each."""
from __future__ import annotations

import pytest

from benchmark import roofline


@pytest.mark.parametrize("b,h,s,d,flops", [
    (8, 20, 1500, 64, 92_160_000_000),  # large-v3's encoder, a batch of 8 windows
    (2, 12, 512, 32, 805_306_368),  # MiniLM at S = 512
])
def test_k3_operations(b, h, s, d, flops):
    assert roofline.flash_attention_flops(b, h, s, d) == flops


def test_k3_bound_is_the_larger_of_compute_and_bytes():
    # [8, 20, 1500, 64] bf16: 92.16 GFLOP / 989 TFLOP/s = 93.2 us against
    # 4 x 30.72 MB / 3.35 TB/s = 36.7 us: compute-bound
    assert roofline.flash_attention_bound_s(8, 20, 1500, 64) == pytest.approx(92.16e9 / 989e12)
    # one head of 16 rows of 128: bytes bound (4 x 4096 B = 16384 B)
    assert roofline.flash_attention_bound_s(1, 1, 16, 128) == pytest.approx(16384 / 3.35e12)


@pytest.mark.parametrize("d,layers,mels,expect", [
    # large-v3, one window: convs 2.949 + 14.746 GFLOP; a layer 19.661 (projections)
    # + 39.322 (MLP) + 11.52 (attention) GFLOP
    (1280, 32, 128, 2_949_120_000 + 14_745_600_000 + 32 * (19_660_800_000 + 39_321_600_000
                                                          + 11_520_000_000)),
    # tiny, one window
    (384, 4, 80, 2 * 3000 * 80 * 3 * 384 + 2 * 1500 * 384 * 3 * 384
     + 4 * (2 * 1500 * 4 * 384 * 384 + 2 * 1500 * 2 * 384 * 1536 + 4 * 1500 * 1500 * 384)),
])
def test_whisper_encoder_operations(d, layers, mels, expect):
    assert roofline.whisper_encoder_flops(1, d, layers, mels) == expect
    assert roofline.whisper_encoder_flops(3, d, layers, mels) == 3 * expect


def test_whisper_decoder_operations():
    # one row at position 0 of large-v3: per layer 13.107 M (self projections)
    # + 5,120 (self scores over 1 key) + 6.554 M (cross query and output)
    # + 7.68 M (cross scores over 1,500) + 26.214 M (MLP); then the logits
    d, v = 1280, 51866
    per_layer = 13_107_200 + 5_120 + 6_553_600 + 7_680_000 + 26_214_400
    assert roofline.whisper_decode_step_flops(1, 0, d, 32, v) == 32 * per_layer + 2 * d * v
    # 40 rows (8 windows x beam 5) at position 99: the self scores see 100 keys
    per_layer_99 = per_layer - 5_120 + 4 * 100 * d
    assert roofline.whisper_decode_step_flops(40, 99, d, 32, v) == \
        40 * (32 * per_layer_99 + 2 * d * v)
    assert roofline.whisper_cross_kv_flops(8, d, 32) == 8 * 32 * 2 * 2 * 1500 * d * d


@pytest.mark.parametrize("tokens,expect", [
    (10, 6 * (2 * 10 * 4 * 384 * 384 + 2 * 10 * 2 * 384 * 1536 + 4 * 100 * 384)),
    (256, 6 * (2 * 256 * 4 * 384 * 384 + 2 * 256 * 2 * 384 * 1536 + 4 * 256 * 256 * 384)),
])
def test_minilm_operations(tokens, expect):
    assert roofline.minilm_flops(tokens) == expect


def test_ivf_probe_operations():
    # 1,024 centroids and 131,072 probed rows of 384
    assert roofline.ivf_probe_flops(1024, 131072) == 2 * 384 * (1024 + 131072)
