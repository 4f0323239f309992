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
``csrc/postprocess_stats.cu`` (one block per band of output rows of a map,
the band's input rows staged in shared memory, then a second launch that adds
the bands' partial sums in band order; see the note there on what bounds
it); :func:`band_plan` sizes the bands and :func:`shared_layout` lays out a
block's shared memory. A CPU tensor goes to
:func:`fused_upsample_stats_plain`, the separable matmul with the same taps.
Both are the implementations of one registered operator,
``torch.ops.wistpu.fused_upsample_stats``, which ``torch.export`` records.
Kernel and plain version agree up to float32 summation order: a bin can flip
only where the upsampled logit is within rounding of zero.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.ops.constants import device_constant
from weed_instance_segmentation_tpu_torch.ops.cuda_build import entry_point, launch
from weed_instance_segmentation_tpu_torch.ops.resize import (
    _bilinear_weights, bilinear_resize_matrix,
)

_LIBRARY = 'postprocess_stats'
LAUNCHES = 'wistpu.fused_upsample_stats.launches'
# Output rows a block makes, and warps a block, where they fit (timed on the
# card by profile_postprocess_stats.py; PERF.md)
BAND_ROWS = 32
WARPS = 6
SEGMENT = 128  # output columns a warp makes at once (csrc/postprocess_stats.cu)
SHARED_TARGET = 64 * 1024  # bands are halved until a block's shared memory fits this
# what a block may take on sm_90 (227 KB) beside the kernel's 128 bytes of
# static arrays (its warps' partial sums)
SHARED_LIMIT = 232448 - 128


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


def tap_table(in_size: int, out_size: int) -> np.ndarray:
    """The kernel's taps: int32 (out, 4) rows of (lo, hi, the bits of
    w_lo, the bits of w_hi), one 16-byte load an output row or column."""
    idx, w = bilinear_taps(in_size, out_size)
    return np.stack([idx[0], idx[1], w[0].view(np.int32), w[1].view(np.int32)], axis=1)


def tile_stores(sw: int) -> bool:
    """Whether the bins leave a block by one bulk copy a band (each row a
    whole number of 16-byte words); else one byte a pixel."""
    return sw % 16 == 0


def shared_layout(wm: int, sw: int, band_rows: int, span_rows: int) -> tuple[int, int, int]:
    """A block's dynamic shared memory (``csrc/postprocess_stats.cu`` takes
    it as given): from float 0 the staged input span, with 3 floats of slack
    to keep 16-byte alignment, or, with :func:`tile_stores`, the band's bins
    once the span is read; from float ``v_off`` the band's vertical values;
    from float ``y_off`` its row taps, one int4 a row. Returns ``(v_off,
    y_off, bytes)``."""
    v_off = (span_rows * wm + 6) // 4 * 4
    if tile_stores(sw):
        v_off = max(v_off, -(-band_rows * sw // 16) * 4)
    y_off = v_off + (band_rows * wm + 3) // 4 * 4
    return v_off, y_off, 4 * y_off + 16 * band_rows


@functools.lru_cache(maxsize=64)
def band_plan(hm: int, wm: int, sh: int, sw: int, band_rows: int,
              shared_target: int = SHARED_TARGET) -> tuple[int, int, int]:
    """(band_rows, bands, span_rows) of a launch: ``band_rows`` output rows
    a block, halved while a block's shared memory exceeds ``shared_target``;
    ``bands = ceil(sh / band_rows)``; and the most input rows a band reads
    (its first row's lo to its last row's hi: the taps are monotone). Raises
    where even a one-row band exceeds the card's shared memory (a steep
    downsample of wide maps)."""
    lo, hi = bilinear_taps(hm, sh)[0]
    band_rows = min(band_rows, sh)
    while True:
        starts = np.arange(0, sh, band_rows)
        ends = np.minimum(starts + band_rows, sh) - 1
        span = int((hi[ends] - lo[starts]).max()) + 1
        smem = shared_layout(wm, sw, band_rows, span)[2]
        if band_rows == 1 or smem <= shared_target:
            break
        band_rows //= 2
    if smem > SHARED_LIMIT:
        raise ValueError(f'a band of {band_rows} output rows of {hm}x{wm} logits resized to '
                         f'{sh}x{sw} needs {smem} bytes of shared memory, beyond the '
                         f'{SHARED_LIMIT} a block may use')
    return band_rows, len(starts), span


def block_threads(sw: int, warps: int) -> int:
    """Threads a block: ``warps`` rounded down to whole sets of the row's
    128-column segments, so that every warp has a segment."""
    segments = -(-sw // SEGMENT)
    return 32 * (warps // segments * segments if segments <= warps else warps)


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


@torch.library.custom_op('wistpu::fused_upsample_stats', mutates_args=(), device_types='cpu',
                         schema='(Tensor mask_logits, int[] score_hw) -> (Tensor, Tensor, Tensor)')
def _op(mask_logits, score_hw):
    return fused_upsample_stats_plain(mask_logits, tuple(score_hw))


@_op.register_kernel('cuda')
def _op_cuda(mask_logits, score_hw):
    return _launch(mask_logits, tuple(score_hw), BAND_ROWS, WARPS, SHARED_TARGET)


@_op.register_fake
def _op_fake(mask_logits, score_hw):
    b, q = mask_logits.shape[:2]
    return (mask_logits.new_empty((b, q)), mask_logits.new_empty((b, q)),
            mask_logits.new_empty((b, q, *score_hw), dtype=torch.int8))


def fused_upsample_stats(mask_logits: torch.Tensor, score_hw: tuple[int, int] = (384, 384)):
    """(B, Q, Hm, Wm) f32 contiguous mask logits → (sig_sum (B, Q) f32,
    pos_cnt (B, Q) f32, bin_i8 (B, Q, sh, sw) int8).

    Calls the registered operator ``torch.ops.wistpu.fused_upsample_stats``
    (so that ``torch.export`` records it): on a CUDA tensor it launches the
    kernel (and raises if it cannot); on a CPU tensor it runs
    :func:`fused_upsample_stats_plain`. Each launch adds one to the counter
    :data:`LAUNCHES` (``engine/trace.py``)."""
    _check(mask_logits, score_hw)
    if mask_logits.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {mask_logits.device}')
    return _op(mask_logits, list(score_hw))


def _launch(mask_logits: torch.Tensor, score_hw: tuple[int, int], band_rows: int, warps: int,
            shared_target: int):
    """The kernel's launch on checked CUDA logits, with its tuning given:
    ``band_rows`` and ``shared_target`` of :func:`band_plan`, ``warps`` of
    :func:`block_threads` (``profile_postprocess_stats.py`` times them)."""
    b, q, hm, wm = mask_logits.shape
    sh, sw = score_hw
    dev = mask_logits.device
    band_rows, bands, span_rows = band_plan(hm, wm, sh, sw, band_rows, shared_target)
    if b * q * bands >= 2 ** 31:
        raise ValueError(f'{b * q} maps of {bands} bands exceed the kernel\'s 32-bit grid')
    v_off, y_off, smem = shared_layout(wm, sw, band_rows, span_rows)
    y_taps = device_constant(tap_table, (hm, sh), dev)
    x_taps = device_constant(tap_table, (wm, sw), dev)
    sig_part = torch.empty((b * q, bands), dtype=torch.float32, device=dev)
    cnt_part = torch.empty((b * q, bands), dtype=torch.int32, device=dev)
    sig_sum = torch.empty((b, q), dtype=torch.float32, device=dev)
    pos_cnt = torch.empty((b, q), dtype=torch.float32, device=dev)
    bins = torch.empty((b, q, sh, sw), dtype=torch.int8, device=dev)
    launch(entry_point(_LIBRARY, 'wis_postprocess_stats', 8, 11), dev, f'{_LIBRARY} kernel',
           mask_logits.data_ptr(), y_taps.data_ptr(), x_taps.data_ptr(), sig_part.data_ptr(),
           cnt_part.data_ptr(), sig_sum.data_ptr(), pos_cnt.data_ptr(), bins.data_ptr(),
           b * q, hm, wm, sh, sw, band_rows, int(tile_stores(sw)), v_off, y_off, smem,
           block_threads(sw, warps))
    trace.count(LAUNCHES)
    return sig_sum, pos_cnt, bins

