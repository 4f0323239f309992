"""Fused on-device image pre-processing.

Port of ``weed_instance_segmentation_tpu/processing/fused.py::fused_preprocess``
— the HF Mask2Former pre-process chain in one pass on the device:

    uint8 HWC → PIL-style antialiased bilinear resize → ×1/255 →
    ImageNet normalize → bottom/right zero-pad, NCHW out (+ pixel mask).

PIL's resize is a separable triangle filter, applied here as two dense
matrix products (horizontal, then vertical, as PIL does) and one
round-half-to-even at the end. PIL's fixed-point arithmetic is approximated
in float32, so outputs match PIL within ±1/255 per channel.
"""

from __future__ import annotations

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.ops.constants import device_constant

# ImageNet statistics, by value from processing/image_processor.py of the JAX package
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def pil_bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) resampling matrix replicating PIL's BILINEAR
    (triangle filter, support widened by the downscale ratio, per-row
    normalization) — Pillow src/libImaging/Resample.c precompute_coeffs."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # triangle filter support = 1

    mat = np.zeros((out_size, in_size), np.float32)
    for x_out in range(out_size):
        center = (x_out + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        span = np.arange(xmin, xmax)
        w = 1.0 - np.abs((span + 0.5 - center) / filterscale)
        w = np.clip(w, 0.0, None)
        s = w.sum()
        if s > 0:
            mat[x_out, xmin:xmax] = w / s
    return mat


def _scaled_stats() -> np.ndarray:
    return np.asarray([IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD], np.float32) * 255.0


def fused_preprocess(
    images: torch.Tensor,
    out_hw: tuple[int, int],
    pad_hw: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B, H, W, 3) → (pixel_values (B, 3, PH, PW) f32,
    pixel_mask (B, PH, PW) f32), on the device of ``images``."""
    if images.dtype != torch.uint8 or images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f'expected uint8 (B, H, W, 3), got {images.dtype} {tuple(images.shape)}')
    b, h, w, _ = images.shape
    oh, ow = out_hw
    ph, pw = pad_hw
    dev = images.device
    rh = device_constant(pil_bilinear_weights, (h, oh), dev)  # (OH, H)
    rw = device_constant(pil_bilinear_weights, (w, ow), dev)  # (OW, W)

    x = images.float()
    x = torch.einsum('pw,bhwc->bhpc', rw, x)
    x = torch.einsum('oh,bhpc->bopc', rh, x)
    x = torch.round(x).clamp_(0.0, 255.0)  # round half to even, like jnp.round

    mean, std = device_constant(_scaled_stats, (), dev)
    x = (x - mean) / std

    pixel_values = torch.zeros((b, 3, ph, pw), dtype=torch.float32, device=dev)
    pixel_values[:, :, :oh, :ow] = x.permute(0, 3, 1, 2)
    pixel_mask = torch.zeros((b, ph, pw), dtype=torch.float32, device=dev)
    pixel_mask[:, :oh, :ow] = 1.0
    return pixel_values, pixel_mask
