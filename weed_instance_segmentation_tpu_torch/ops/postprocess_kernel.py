"""Fused post-process mask-logit statistics: CUDA kernel and plain version.

Port of the Pallas TPU kernel
``weed_instance_segmentation_tpu/ops/postprocess_kernel.py::fused_upsample_stats``.
The HF instance post-process upsamples every query's mask logits to the
fixed 384² scoring resolution and reduces them; this computes, per
(batch, query) map and without writing the upsampled logits to memory:

- ``sig_sum[b, q]`` — Σ sigmoid(up) over pixels where up > 0
- ``pos_cnt[b, q]`` — #pixels where up > 0 (float32)
- ``bin_i8[b, q, sh, sw]`` — the binarized mask, int8

The upsample is the separable bilinear of ``ops/resize.py::
bilinear_resize_matrix``. A CUDA tensor goes to the kernel in
``csrc/postprocess_stats.cu`` (one block per map; see the note there on what
bounds it); a CPU tensor goes to :func:`fused_upsample_stats_plain`, the
separable matmul with the same taps. Kernel and plain version agree up to
float32 summation order: a bin can flip only where the upsampled logit is
within rounding of zero.
"""

from __future__ import annotations

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.ops.constants import device_constant
from weed_instance_segmentation_tpu_torch.ops.cuda_build import entry_point, launch
from weed_instance_segmentation_tpu_torch.ops.resize import (
    _bilinear_weights, bilinear_resize_matrix,
)

_LIBRARY = 'postprocess_stats'


def bilinear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """The rows of :func:`bilinear_resize_matrix` as 2-tap arrays:
    ``idx`` int32 (2, out) = (lo, hi) and ``w`` float32 (2, out) = their
    weights. Where lo == hi the weights are merged onto lo exactly as the
    matrix accumulates them (in float64), so ``w`` holds the matrix entries."""
    lo, hi, frac = _bilinear_weights(in_size, out_size)
    w_lo = 1.0 - frac.astype(np.float64)
    w_hi = frac.astype(np.float64)
    same = lo == hi
    w_lo = np.where(same, w_lo + w_hi, w_lo)
    w_hi = np.where(same, 0.0, w_hi)
    idx = np.stack([lo, hi]).astype(np.int32)
    return idx, np.stack([w_lo, w_hi]).astype(np.float32)


def _tap_indices(in_size: int, out_size: int) -> np.ndarray:
    return bilinear_taps(in_size, out_size)[0]


def _tap_weights(in_size: int, out_size: int) -> np.ndarray:
    return bilinear_taps(in_size, out_size)[1]


def upsample_plain(mask_logits: torch.Tensor, score_hw: tuple[int, int]) -> torch.Tensor:
    """(..., Hm, Wm) → (..., sh, sw) f32 as ``Wy @ M @ Wx^T``."""
    hm, wm = mask_logits.shape[-2:]
    dev = mask_logits.device
    wy = device_constant(bilinear_resize_matrix, (hm, score_hw[0]), dev)
    wx = device_constant(bilinear_resize_matrix, (wm, score_hw[1]), dev)
    return torch.matmul(torch.matmul(wy, mask_logits.float()), wx.T)


def fused_upsample_stats_plain(mask_logits: torch.Tensor, score_hw: tuple[int, int] = (384, 384)):
    """Plain PyTorch version of the kernel: same outputs, same taps."""
    up = upsample_plain(mask_logits, score_hw)
    pos = up > 0
    sig_sum = torch.where(pos, torch.sigmoid(up), 0.0).sum(dim=(-1, -2))
    pos_cnt = pos.sum(dim=(-1, -2), dtype=torch.float32)
    return sig_sum, pos_cnt, pos.to(torch.int8)


def _check(mask_logits: torch.Tensor, score_hw: tuple[int, int]) -> None:
    if mask_logits.dtype != torch.float32:
        raise TypeError(f'mask_logits must be float32, got {mask_logits.dtype}')
    if mask_logits.ndim != 4 or min(mask_logits.shape[2:]) < 1:
        raise ValueError(f'mask_logits must be (B, Q, Hm, Wm), got {tuple(mask_logits.shape)}')
    if not mask_logits.is_contiguous():
        raise ValueError('mask_logits must be contiguous')
    if len(score_hw) != 2 or min(score_hw) < 1:
        raise ValueError(f'score_hw must be two positive sizes, got {score_hw}')
    b, q, hm, wm = mask_logits.shape
    if max(b * q, hm * wm, score_hw[0] * score_hw[1]) >= 2 ** 31:
        raise ValueError('sizes beyond the kernel\'s 32-bit map and pixel counts')


def fused_upsample_stats(mask_logits: torch.Tensor, score_hw: tuple[int, int] = (384, 384)):
    """(B, Q, Hm, Wm) f32 contiguous mask logits → (sig_sum (B, Q) f32,
    pos_cnt (B, Q) f32, bin_i8 (B, Q, sh, sw) int8).

    On a CUDA tensor this launches the kernel (and raises if it cannot); on a
    CPU tensor it runs :func:`fused_upsample_stats_plain`. Each launch adds
    one to ``fused_upsample_stats.launches``."""
    _check(mask_logits, score_hw)
    if mask_logits.device.type == 'cpu':
        return fused_upsample_stats_plain(mask_logits, score_hw)
    if mask_logits.device.type != 'cuda':
        raise ValueError(f'no kernel for device {mask_logits.device}')

    b, q, hm, wm = mask_logits.shape
    sh, sw = score_hw
    dev = mask_logits.device
    y_idx = device_constant(_tap_indices, (hm, sh), dev)
    y_w = device_constant(_tap_weights, (hm, sh), dev)
    x_idx = device_constant(_tap_indices, (wm, sw), dev)
    x_w = device_constant(_tap_weights, (wm, sw), dev)
    sig_sum = torch.empty((b, q), dtype=torch.float32, device=dev)
    pos_cnt = torch.empty((b, q), dtype=torch.float32, device=dev)
    bins = torch.empty((b, q, sh, sw), dtype=torch.int8, device=dev)
    launch(entry_point(_LIBRARY, 'wis_postprocess_stats', 8, 5), dev, f'{_LIBRARY} kernel',
           mask_logits.data_ptr(), y_idx.data_ptr(), y_w.data_ptr(), x_idx.data_ptr(),
           x_w.data_ptr(), sig_sum.data_ptr(), pos_cnt.data_ptr(), bins.data_ptr(),
           b * q, hm, wm, sh, sw)
    fused_upsample_stats.launches += 1
    return sig_sum, pos_cnt, bins


fused_upsample_stats.launches = 0
