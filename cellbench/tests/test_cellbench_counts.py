"""The yardstick's FLOP and byte counts against hand counts at small
shapes."""

import torch
import torch.nn.functional as F

from cellbench import counts


def _conv_flops(b, cin, cout, k, hout, wout, groups=1):
    return 2 * b * cout * (cin // groups) * k * k * hout * wout


def test_conv_flops_by_hand():
    x = torch.empty((2, 8, 16, 16), device="meta")
    w = torch.empty((4, 8, 3, 3), device="meta")
    assert counts._count(lambda: F.conv2d(x, w, None, 1, 1)) == \
        _conv_flops(2, 8, 4, 3, 16, 16)
    dw = torch.empty((8, 1, 5, 5), device="meta")
    assert counts._count(lambda: F.conv2d(x, dw, None, 2, 2, 1, 8)) == \
        _conv_flops(2, 8, 8, 5, 8, 8, groups=8)


def test_training_counts_three_products_less_the_stem_input_gradient():
    for enc, (cout, k) in (("resnet34", (64, 7)),
                           ("efficientnet-b0", (32, 3))):
        fwd = counts.unet_flops(enc, 2, 64, backward=False)
        step = counts.unet_flops(enc, 2, 64, backward=True)
        stem = _conv_flops(2, 3, cout, k, 32, 32)
        assert step == 3 * fwd - stem


def test_forward_grows_with_the_batch():
    one = counts.unet_flops("efficientnet-b0", 1, 64, backward=False)
    assert counts.unet_flops("efficientnet-b0", 3, 64, False) == 3 * one


def test_bytes_by_hand():
    assert counts.cc_bytes(2, 4, 8) == 2 * 4 * 8 * 1 + 2 * 4 * 8 * 4
    assert counts.median_bytes(3, 10) == 3 * 10 * 4 + 3 * 4
    assert counts.lsr_fwd_bytes(5, 8, 8) == 5 * 8 * 4 + 5 * 8 + 5 * 4
    assert counts.lsr_bwd_bytes(5, 8, 4) == \
        5 * 8 * 4 + 5 * 4 + 5 * 4 + 5 * 8 * 4


def test_peaks_of_the_card():
    p = counts.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops_per_s"] == 989e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert counts.peaks("a card not in the table") is None
