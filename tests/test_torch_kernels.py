"""The post-process CUDA kernel's wrapper, tap layout and, on a card, the
kernel against its plain version.

This file imports neither jax nor the JAX package, so the ``cuda`` tests also
run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from weed_instance_segmentation_tpu_torch.ops.postprocess_kernel import (
    bilinear_taps, fused_upsample_stats, fused_upsample_stats_plain, upsample_plain,
)
from weed_instance_segmentation_tpu_torch.ops.resize import bilinear_resize_matrix


@pytest.mark.parametrize('in_size,out_size', [(200, 384), (25, 384), (384, 200), (7, 7), (1, 5)])
def test_taps_hold_the_resize_matrix(in_size, out_size):
    """The kernel's 2-tap arrays are the rows of the plain version's matrix,
    bit for bit."""
    idx, w = bilinear_taps(in_size, out_size)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    dense = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    dense[rows, idx[0]] += w[0]
    dense[rows, idx[1]] += w[1]  # w[1] is 0 where lo == hi
    np.testing.assert_array_equal(dense, bilinear_resize_matrix(in_size, out_size))


def test_tap_gather_form_matches_plain():
    """The kernel's arithmetic (rows first, then columns, two taps each),
    in numpy, against the plain matmul form."""
    logits = np.random.default_rng(0).standard_normal((3, 17, 23)).astype(np.float32)
    (ylo, yhi), (wy0, wy1) = bilinear_taps(17, 40)
    (xlo, xhi), (wx0, wx1) = bilinear_taps(23, 30)
    r0 = wy0[:, None] * logits[:, ylo][:, :, xlo] + wy1[:, None] * logits[:, yhi][:, :, xlo]
    r1 = wy0[:, None] * logits[:, ylo][:, :, xhi] + wy1[:, None] * logits[:, yhi][:, :, xhi]
    up = wx0 * r0 + wx1 * r1
    want = upsample_plain(torch.from_numpy(logits), (40, 30)).numpy()
    np.testing.assert_allclose(up, want, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    good = torch.zeros((1, 2, 4, 4))
    with pytest.raises(TypeError, match='float32'):
        fused_upsample_stats(good.double(), (8, 8))
    with pytest.raises(ValueError, match='B, Q, Hm, Wm'):
        fused_upsample_stats(good[0], (8, 8))
    with pytest.raises(ValueError, match='contiguous'):
        fused_upsample_stats(good.transpose(2, 3), (8, 8))
    with pytest.raises(ValueError, match='score_hw'):
        fused_upsample_stats(good, (0, 8))
    with pytest.raises(ValueError, match='no kernel for device'):
        fused_upsample_stats(good.to('meta'), (8, 8))


def test_cpu_tensor_runs_the_plain_version():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 3, 10, 12)).astype(np.float32))
    launches = fused_upsample_stats.launches
    got = fused_upsample_stats(logits, (24, 20))
    want = fused_upsample_stats_plain(logits, (24, 20))
    assert fused_upsample_stats.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape == got[1].shape == (2, 3) and got[2].shape == (2, 3, 24, 20)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with nvcc: the CUDA kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('shape,score_hw', [((2, 16, 200, 200), (384, 384)),
                                            ((1, 3, 37, 50), (96, 64))])
def test_kernel_matches_plain_on_card(cuda_device, shape, score_hw):
    """sig_sum within rtol 1e-5, after allowing each bin flip its sigmoid
    (≈0.5); every flipped bin lies where the plain upsample is within 1e-5
    of zero (a sign change from float32 summation order)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    logits = torch.randn(shape, generator=g, device=cuda_device) * 2
    launches = fused_upsample_stats.launches
    sig, cnt, bins = fused_upsample_stats(logits, score_hw)
    torch.cuda.synchronize()
    assert fused_upsample_stats.launches == launches + 1
    up = upsample_plain(logits, score_hw)
    p_sig, p_cnt, p_bins = fused_upsample_stats_plain(logits, score_hw)
    flips = bins != p_bins
    if flips.any():
        assert up[flips].abs().max().item() <= 1e-5
    flips_per_map = flips.sum(dim=(-1, -2)).float()
    assert ((cnt - p_cnt).abs() <= flips_per_map).all()
    assert ((sig - p_sig).abs() <= 1e-5 * p_sig.abs() + 0.5001 * flips_per_map).all()
