"""The copied FLOP and roofline arithmetic at the cells' shapes, against
values worked out by hand."""

import pytest

from benchmark.lib import arith


def test_frame_flops_at_both_shapes():
    # 512x384: stem 512*384*15*64*49, downs 256*192*64*128*9 + ...,
    # 9 resblocks 2*(64*48*512*512*9) each, ups, heads 512*384*64*6*49.
    assert arith.frame_flops(384, 512) == pytest.approx(395.53e9, rel=1e-4)
    assert arith.frame_flops(512, 896) == pytest.approx(922.9e9, rel=1e-4)
    # The model's work is fixed by its widths: 896x512 is 2.333x 512x384.
    assert (arith.frame_flops(512, 896) / arith.frame_flops(384, 512)
            == pytest.approx(896 * 512 / (512 * 384)))


def test_b1_ops_and_bytes_at_batch4_henan():
    ops, nbytes = arith.b1_ops_bytes(4, 64, 112, 512)
    npx = 4 * 64 * 112
    assert ops == 2.0 * npx * 512 * 9 * 512 == 135291469824.0
    # x and y bf16, the kernel bf16, an f32 bias, f32 mean and var.
    assert nbytes == (2 * npx * 512 * 2 + 9 * 512 * 512 * 2 + 4 * 512
                      + 2 * 4 * 4 * 512) == 63457280
    peak = arith.peaks("NVIDIA H100 80GB HBM3")
    assert peak["bf16_flops_per_s"] == 989e12
    # Bound by operations: 0.1368 ms against 0.0189 ms of bytes (2.33x
    # the 0.0586 ms of [4,48,64,512]).
    assert arith.bound_s(ops, nbytes, peak) == pytest.approx(ops / 989e12)
    assert arith.bound_s(ops, nbytes, peak) == pytest.approx(1.368e-4,
                                                             rel=1e-3)


def test_unknown_card_has_no_peak():
    assert arith.peaks("cpu") is None
