"""The frozen yardstick gives fixed numbers on fixed shapes."""
from __future__ import annotations

import pytest

from avatarbench import roofline


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.BF16_FLOP_PER_S == 989e12
    assert roofline.FP32_FLOP_PER_S == 67e12


def test_head_cost_and_bound():
    # 56 -> 64 -> 16, 15 -> 64 -> 64 -> 3: 3584 + 1024 + 960 + 4096 + 192
    assert roofline.head_cost(1, 56) == (2 * 9856, 2 * 56 + 16)
    flops, nbytes = roofline.head_cost(1_500_000, 56)
    assert (flops, nbytes) == (29_568_000_000, 192_000_000)
    t, what = roofline.head_bound(1_500_000, 56)
    assert what == "bytes" and t == pytest.approx(192e6 / 3.35e12)


def test_encode_bytes():
    L, T, F = 16, 1 << 19, 2
    fwd = roofline.encode_bytes(1_048_576, 0, L, T, F)
    assert fwd == 1_048_576 * (12 + 128)
    bwd = roofline.encode_bytes(1_048_576, 0, L, T, F, forward=False,
                                table_grad=True)
    assert bwd == 1_048_576 * (12 + 128) + L * T * F * 4
    # touched rows never count more than the table holds
    assert (roofline.encode_bytes(10, 10 ** 9, L, T, F, forward=False)
            == 120 + L * T * F * 4)
    assert roofline.encode_bound(1, 0, L, T, F) == pytest.approx(
        140 / 3.35e12)


def test_mlp_flops():
    assert roofline.mlp_flops([32, 64, 16]) == 2 * (2048 + 1024)
    assert roofline.mlp_flops([15, 64, 64, 3]) == 2 * (960 + 4096 + 192)
