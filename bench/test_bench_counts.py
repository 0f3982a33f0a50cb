"""The benchmark's own count of a step's work (``harness/counts.py``)
against values worked by hand: one convolution, one BN site, one MoE
layer, and ResNet-50's totals."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import counts  # noqa: E402

RESNET50 = {"conv_width": 64, "image_size": 224,
            "conv_stages": [3, 4, 6, 3], "num_classes": 1000}


def test_stem_convolution():
    # 7x7/2 over 224 px: 112 x 112 outputs, 3 -> 64 channels
    px, ci, co, k = counts.resnet_convs(RESNET50)[0]
    assert (px, ci, co, k) == (112 * 112, 3, 64, 7)
    assert 2 * px * ci * co * k * k == 236_027_904


def test_resnet50_totals():
    # 4.09 G multiply-adds an image with the stride on the 3x3 conv
    # (v1.5), the projections and the fc; 53 BN sites
    fwd_macs = counts.resnet_step_flops(RESNET50, 1) / 3 / 2
    assert fwd_macs == 4_089_184_256
    sites = counts.resnet_bn_sites(RESNET50, 256)
    assert len(sites) == 53
    assert sites[0] == (256 * 112 * 112, 64, True, False)


def test_one_bn_site():
    # 100 rows x 8 channels of bf16 under a ReLU, with a residual:
    # forward x, res read and y written (3 x 1,600 B) + scale, bias
    # read and mean, var written (4 x 8 x 4 B); backward x, dy, y read
    # and dx, d_res written (5 x 1,600 B) + 5 x 8 x 4 B
    assert counts.bn_site_bytes(100, 8, True, True) == 4800 + 128 + 8000 \
        + 160
    assert counts.bn_site_bytes(100, 8, False, False) == 3200 + 128 \
        + 4800 + 160


def test_one_moe_layer():
    # d 4, 2 / 1 heads of 2, 4 experts of 8, top-2, vocabulary 10, one
    # row of 3 tokens: projections 3*2*4*2*(2*2+2*1) = 288; causal scores
    # (1+2+3)*2*2*2*2 = 96; router 3*2*4*4 = 96; experts 3*2*3*2*4*8 =
    # 1,152; head 3*2*4*10 = 240; forward 1,872, x 3
    model = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2,
             "d_ff": 8, "n_experts": 4, "experts_per_token": 2,
             "vocab_size": 10, "n_layers": 1, "sliding_window": None}
    assert counts.mixtral_step_flops(model, 1, 3) == 3 * 1872


def test_window_cuts_the_scores():
    model = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2,
             "d_ff": 8, "n_experts": 4, "experts_per_token": 2,
             "vocab_size": 10, "n_layers": 1, "sliding_window": 2}
    # each query sees at most 2 keys: (1+2+2) instead of (1+2+3)
    assert counts.mixtral_step_flops(model, 1, 3) == 3 * (1872 - 16)


@pytest.mark.parametrize("n", [1, 10, 1_713_418_240])
def test_update_bytes(n):
    # the hybrid update reads g, theta, Delta, m and writes three (28 B),
    # the wire casts f32 -> bf16 -> f32 (12 B)
    assert counts.update_bytes(n) == 40 * n
