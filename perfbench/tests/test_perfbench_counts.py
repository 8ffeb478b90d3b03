"""The yardstick's counts against hand counts at the published shapes."""
from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.lib import counts, peaks, seeded

QWEN = seeded.lm_dims(harness.load_json(
    harness.BENCH_DIR / "configs" / "qwen2-7b.json"))
ALEX = seeded.cnn_layers(harness.load_json(
    harness.BENCH_DIR / "configs" / "alexnet-pv38.json"))


def test_qwen2_7b_kept_units_and_parameters():
    k = counts.lm_kept(QWEN, 0.5)
    assert k == {"hk": 14, "gk": 2, "fk": 9472}
    total = sum(int(torch_numel(s)) for s in seeded.lm_shapes(QWEN).values())
    assert total == 7_615_616_512          # Qwen2-7B's published count


def torch_numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def test_qwen2_7b_prefill_flops_by_hand():
    k = counts.lm_kept(QWEN, 0.5)
    B, S = 4, 4096
    d, D = 3584, 128
    proj = 2 * d * D * (14 + 2 * 2) + 2 * 14 * D * d + 6 * d * 9472
    attn = 4 * 14 * D * (S * (S + 1) // 2)
    want = 28 * (B * S * proj + B * attn) + 2 * B * d * 152064
    assert counts.lm_prefill_flops(QWEN, k, B, S) == pytest.approx(want)
    # decode: 64 rows each seeing 2,049 keys
    want = 28 * (64 * proj + 4 * 14 * D * 64 * 2049) + 2 * 64 * d * 152064
    assert counts.lm_decode_flops(QWEN, k, 64, 64 * 2049) \
        == pytest.approx(want)


def test_masked_matmul_and_flash_bounds_by_hand():
    # a prefill's up product at 4 x 4,096 rows: compute-bound
    M, K, N, kept = 16384, 3584, 18944, 9472
    flops = 2 * M * K * kept
    assert counts.masked_matmul_bf16(M, K, N, kept) \
        == pytest.approx(flops / 989e12)
    # a decode step's at 64 rows: bound by the kept half of the weights
    nbytes = 2 * (64 * K + K * kept + 64 * kept) + 4 * N
    assert counts.masked_matmul_bf16(64, K, N, kept) \
        == pytest.approx(nbytes / 3.35e12)
    # causal attention, 14 heads over 2 KV groups, D = 128, S = 2,048
    flops = 4 * 14 * 128 * 2048 * 2049 / 2
    assert counts.flash_bf16(1, 2048, 14, 2, 128) \
        == pytest.approx(max(flops / 989e12,
                             2 * 2048 * 128 * (28 + 4) / 3.35e12))


def test_alexnet_gemms_by_hand():
    full = counts.cnn_kept_layers(ALEX, {})
    assert [(g["M"], g["K"], g["N"]) for g in full] == [
        (55 * 55, 11 * 11 * 3, 64), (27 * 27, 25 * 64, 192),
        (13 * 13, 9 * 192, 384), (13 * 13, 9 * 384, 256),
        (13 * 13, 9 * 256, 256), (1, 9216, 4096), (1, 4096, 4096),
        (1, 4096, 38)]
    # AlexNet's well-known ~0.71 G multiply-adds an image (torchvision)
    assert counts.cnn_forward_flops(full) / 2 == pytest.approx(714e6,
                                                               rel=0.01)
    half = {i: ALEX[i]["out"][0] // 2 for i in seeded.prunable(ALEX)}
    kept = counts.cnn_kept_layers(ALEX, half)
    assert [(g["K"], g["N"]) for g in kept] == [
        (363, 32), (25 * 32, 96), (9 * 96, 192), (9 * 192, 128),
        (9 * 128, 128), (36 * 128, 2048), (2048, 2048), (2048, 38)]
    g = kept[0]
    nbytes = 4 * 3025 * 363 + 363 * 32 + 12 * 32 + 4 * 3025 * 32
    assert counts.q8_splitk(g) == pytest.approx(
        max(2 * 3025 * 363 * 32 / 1979e12, nbytes / 3.35e12))


def test_peaks_are_the_data_sheet():
    assert peaks.FLOP_S["bfloat16"] == 989e12
    assert peaks.FLOP_S["int8"] == 1979e12
    assert peaks.FLOP_S["float32"] == 67e12
    assert peaks.HBM_BYTES_S == 3.35e12
