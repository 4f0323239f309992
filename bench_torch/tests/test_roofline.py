"""The work counts of ``roofline.py`` against hand counts at small shapes,
and the whole model's FLOPs against torch's FLOP counter on the reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig

from bench_torch import roofline
from bench_torch.reference.model import Mask2Former
from bench_torch.tests.tiny import config_dict


def test_window_attention_counts():
    # q, k, v (2, 1, 4, 2) bf16 = 32 B each; bias and one mask window (4, 4) f32
    assert roofline.window_attention(2, 1, 4, 2, 'bfloat16', True, 1) == (
        4 * 32 + 2 * 64 + 2 * 4 * 4, 4 * 2 * 4 * 4 * 2)
    assert roofline.window_attention(2, 1, 4, 2, 'bfloat16', False, backward=True) == (
        8 * 32 + 64 + 32 + 64, 10 * 2 * 4 * 4 * 2)


def test_masked_attention_counts():
    # q (1, 1, 2, 2) and k/v (1, 1, 3, 2) bf16; mask (1, 1, 2, 3) bytes; lse (1, 1, 2) f32
    assert roofline.masked_attention(1, 1, 2, 3, 2, 'bfloat16') == (
        2 * 8 + 2 * 12 + 6 + 8, 4 * 2 * 3 * 2)
    assert roofline.masked_attention(1, 1, 2, 3, 2, 'bfloat16', backward=True) == (
        4 * 8 + 4 * 12 + 6 + 8, 10 * 2 * 3 * 2)


def test_postprocess_counts():
    # logits (1, 1, 2, 2) f32 read; 4x4 int8 bins and two f32 sums written
    assert roofline.postprocess(1, 1, 2, 2, (4, 4)) == (16 + 16 + 8, 12 * 16)


def test_msda_counts():
    # value (1, 4, 1, 2) bf16, one sample of f32 coordinates and weight, output (1, 1, 2) bf16
    assert roofline.msda(1, 1, 1, 1, 1, 2, 4, 'bfloat16', 'float32') == (16 + 12 + 4, 16)
    assert roofline.msda(1, 1, 1, 1, 1, 2, 4, 'bfloat16', 'float32', backward=True) == (
        64, 32)


def test_bound_takes_the_slower_roof():
    assert roofline.bound_s(3.35e12, 0, 'bfloat16') == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12, 'float32') == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 989e12, 'bfloat16') == pytest.approx(2.0)


@pytest.mark.parametrize('cfg, hw', [
    (Mask2FormerConfig.tiny_test(num_labels=5), (72, 88)),  # padded windows
    (Mask2FormerConfig.resnet50(num_labels=5, num_queries=10), (64, 96)),
])
def test_model_flops_match_the_counter(cfg, hw):
    """Every product the reference computes, as torch counts them, and the
    deformable sampling's bilinear taps, which it does not."""
    d = config_dict(cfg, 'any')
    model = Mask2Former(d).eval().requires_grad_(False)
    with FlopCounterMode(display=False) as counter:
        model(torch.randn(1, 3, *hw))
    shapes = roofline.feature_shapes(d, *hw)
    levels = d['num_feature_levels']
    tokens = sum(h * w for h, w in shapes[::-1][:levels])
    taps = (cfg.encoder_layers * 2 * tokens * cfg.num_attention_heads * levels
            * cfg.encoder_n_points * 4 * (cfg.feature_size // cfg.num_attention_heads))
    assert roofline.model_flops(d, *hw) == counter.get_total_flops() + taps
