"""Resize primitives: PIL's on the host, torch ``F.interpolate``'s on the
device.

Counterpart of ``weed_instance_segmentation_tpu/ops/resize.py``. The host
pair (:func:`pil_resize_image`, :func:`pil_resize_mask`) is what the image
processor and the dataset readers resize with; each imports PIL when called,
so this module imports without it. The device functions have
``F.interpolate``'s semantics:

- bilinear with ``align_corners=False`` and no antialiasing — the 384² logit
  upsample of the post-process (HF:image_processing_mask2former.py:1122-1124),
  the FPN top-down step and the decoder's attention-mask resize;
- *legacy* nearest (``mode='nearest'``: src = floor(dst * in/out),
  HF:1156-1160), not ``nearest-exact``.

The numpy tap functions are shared with the post-process kernel, which takes
the same 2-tap indices and weights as small host-built arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pil_resize_image(image: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear-resize an HWC uint8 image exactly as PIL does (antialiased)."""
    from PIL import Image

    h, w = size_hw
    return np.asarray(Image.fromarray(image).resize((w, h), resample=Image.BILINEAR))


def pil_resize_mask(mask: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """Nearest-resize a 2-D integer map exactly as PIL does (mode I)."""
    from PIL import Image

    h, w = size_hw
    pil = Image.fromarray(mask.astype(np.int32), mode='I')
    return np.asarray(pil.resize((w, h), resample=Image.NEAREST)).astype(mask.dtype)


def _bilinear_weights(in_size: int, out_size: int):
    """Source indices/weights for align_corners=False half-pixel sampling."""
    scale = in_size / out_size
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, None)  # torch clamps negative coords to 0
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (coords - lo).astype(np.float32)
    lo = np.minimum(lo, in_size - 1)
    return lo, hi, frac


def bilinear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) f32 matrix of the 2-tap bilinear, for resizing as
    ``Wy @ x @ Wx^T``. Weights are accumulated in float64 so the degenerate
    lo==hi edge taps sum to exactly 1.0."""
    lo, hi, frac = _bilinear_weights(in_size, out_size)
    w = np.zeros((out_size, in_size), np.float64)
    rows = np.arange(out_size)
    w[rows, lo] += 1.0 - frac.astype(np.float64)
    w[rows, hi] += frac.astype(np.float64)
    return w.astype(np.float32)


def interpolate_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear', align_corners=False)`` on the
    last two axes of ``x`` (any leading batch/channel dims)."""
    h_in, w_in = x.shape[-2:]
    if (h_in, w_in) == tuple(out_hw):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, h_in, w_in), size=tuple(out_hw), mode='bilinear',
                      align_corners=False, antialias=False)
    return y.reshape(*lead, *out_hw)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """torch legacy nearest source index per output pixel: floor(dst*in/out)."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def interpolate_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch legacy ``F.interpolate(mode='nearest')`` on the last two axes."""
    h_in, w_in = x.shape[-2:]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    ys = torch.from_numpy(nearest_indices(h_in, h_out)).to(x.device)
    xs = torch.from_numpy(nearest_indices(w_in, w_out)).to(x.device)
    return x[..., ys, :][..., xs]
