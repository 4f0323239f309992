"""Device-side training augmentation, off by default (``WISTPU_AUGMENT``).

Port of ``weed_instance_segmentation_tpu/processing/augment.py``: pure
tensor code on the collated static batch (``datasets/dataset_utils.py::
pad_batch_static``), run inside the train step's loss function on the
device, before the forward.

- Geometry: one affine grid a sample (horizontal flip, scale jitter and a
  random shift; zeros pad) sampled through ``ops/grid_sample.py`` at the
  batch's own shape. The instance masks and the pixel mask ride the same
  grid with nearest taps (round half to even, as ``jnp.round``), so the
  labels stay aligned with the pixels. A sample neither flipped nor scaled
  is left exactly as it was.
- Colour: brightness and contrast in raw-pixel space (the ImageNet affine
  undone, then redone), the contrast pivot the mean over real pixels only,
  clipped to [0, 1] and the padding re-zeroed.
- An instance cropped wholly out of frame is cleared from
  ``instance_valid``, so it never reaches the matcher as an empty target.

Drawing the per-sample factors (:func:`draw_factors`) is split from
applying them (:func:`apply_factors`), so a test can feed the port the
factors the JAX package drew. The JAX package draws them from six keys
split from ``fold_in(rng, 3)``; the port draws them, in the same order,
from the step's generator before the drop-path masks and the criterion's
points (``losses/criterion.py::PointDraws``), as a data rank's rows of the
global batch's draw.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from weed_instance_segmentation_tpu_torch.ops.grid_sample import grid_sample_bilinear
from weed_instance_segmentation_tpu_torch.parallel.mesh import rand_rows
from weed_instance_segmentation_tpu_torch.processing.image_processor import (
    IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD,
)


@dataclass(frozen=True)
class AugmentConfig:
    hflip_prob: float = 0.5
    scale_prob: float = 0.5
    scale_range: tuple[float, float] = (0.8, 1.25)  # <1 zoom out, >1 zoom in
    brightness: float = 0.2  # factor ~ U[1-b, 1+b]
    contrast: float = 0.2    # factor ~ U[1-c, 1+c]

    def any_enabled(self) -> bool:
        return (self.hflip_prob > 0 or self.scale_prob > 0
                or self.brightness > 0 or self.contrast > 0)


def draw_factors(batch: int, cfg: AugmentConfig, generator: torch.Generator | None,
                 device: torch.device, shard: tuple[int, int] | None = None) -> dict:
    """The per-sample factors of ``batch`` samples: ``flip`` (B,) 0/1,
    ``scale`` (B,) (1 where not scaled), ``shift`` (B, 2) in
    source-normalised units, ``brightness`` and ``contrast`` (B,)."""
    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * rand_rows(shape, generator, device, shard)

    flip = (uniform((batch,)) < cfg.hflip_prob).float()
    scale_on = uniform((batch,)) < cfg.scale_prob
    scale = torch.where(scale_on, uniform((batch,), *cfg.scale_range), 1.0)
    # a zoom-in window of half-extent 1/s may shift by up to 1 - 1/s and
    # stay inside the source; zoom-out windows overhang anyway: no shift
    max_shift = torch.clamp(1.0 - 1.0 / scale, min=0.0)
    shift = uniform((batch, 2), -1.0, 1.0) * max_shift[:, None]
    brightness = uniform((batch,), 1.0 - cfg.brightness, 1.0 + cfg.brightness)
    contrast = uniform((batch,), 1.0 - cfg.contrast, 1.0 + cfg.contrast)
    return {'flip': flip, 'scale': scale, 'shift': shift, 'brightness': brightness,
            'contrast': contrast}


def _nearest_grid_sample(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """grid_sample with nearest taps and zeros padding (align_corners=False
    unnormalisation, ties to even). value (N, C, H, W), grid (N, Hg, Wg, 2)."""
    n, c, h, w = value.shape
    x = ((grid[..., 0] + 1.0) * w - 1.0) / 2.0
    y = ((grid[..., 1] + 1.0) * h - 1.0) / 2.0
    ix = torch.round(x)
    iy = torch.round(y)
    valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
    idx = (iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()).reshape(n, 1, -1)
    out = torch.gather(value.reshape(n, c, h * w), 2, idx.expand(n, c, -1))
    return out.reshape(n, c, *grid.shape[1:3]) * valid[:, None].to(value.dtype)


def _affine_grid(shape_hw: tuple[int, int], scale: torch.Tensor, shift: torch.Tensor,
                 flip: torch.Tensor) -> torch.Tensor:
    """Per-sample sampling grid (B, H, W, 2) in [-1, 1] source coordinates:
    the output pixel at normalised u reads the source at u / scale + shift,
    x mirrored where ``flip`` is 1."""
    h, w = shape_hw
    ys = (torch.arange(h, dtype=torch.float32, device=scale.device) + 0.5) * (2.0 / h) - 1.0
    xs = (torch.arange(w, dtype=torch.float32, device=scale.device) + 0.5) * (2.0 / w) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    sign = 1.0 - 2.0 * flip
    sx = gx[None] * sign[:, None, None] / scale[:, None, None] + shift[:, 0, None, None]
    sy = gy[None] / scale[:, None, None] + shift[:, 1, None, None]
    return torch.stack([sx, sy], dim=-1)


def apply_factors(batch: dict, factors: dict, cfg: AugmentConfig) -> dict:
    """``batch`` with ``pixel_values``, ``mask_labels`` (float), ``pixel_mask``
    and ``instance_valid`` augmented by ``factors`` (:func:`draw_factors`);
    every other key passes through."""
    pixel_values = batch['pixel_values']  # (B, 3, H, W)
    mask_labels = batch['mask_labels'].float()  # (B, N, H, W)
    pixel_mask = batch['pixel_mask'].float()  # (B, H, W)
    b, _, h, w = pixel_values.shape
    scale, flip = factors['scale'], factors['flip']
    grid = _affine_grid((h, w), scale, factors['shift'], flip)

    keep = ((scale == 1.0) & (flip == 0.0))[:, None, None, None]
    sampled = grid_sample_bilinear(pixel_values, grid)
    masks_and_valid = torch.cat([mask_labels, pixel_mask[:, None]], dim=1)
    sampled_mv = _nearest_grid_sample(masks_and_valid, grid)
    pixel_values = torch.where(keep, pixel_values, sampled)
    masks_and_valid = torch.where(keep, masks_and_valid, sampled_mv)
    mask_labels = masks_and_valid[:, :-1]
    pixel_mask = masks_and_valid[:, -1]

    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, dtype=pixel_values.dtype,
                        device=pixel_values.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_DEFAULT_STD, dtype=pixel_values.dtype,
                       device=pixel_values.device).reshape(1, 3, 1, 1)
    raw = pixel_values * std + mean
    if cfg.brightness > 0:
        raw = raw * factors['brightness'].reshape(b, 1, 1, 1)
    if cfg.contrast > 0:
        npix = torch.clamp(pixel_mask.sum(dim=(1, 2)), min=1.0).reshape(b, 1, 1, 1)
        gray = (raw * pixel_mask[:, None]).sum(dim=(2, 3), keepdim=True).mean(
            dim=1, keepdim=True) / npix
        raw = gray + factors['contrast'].reshape(b, 1, 1, 1) * (raw - gray)
    raw = torch.clamp(raw, 0.0, 1.0)
    pixel_values = (raw - mean) / std * pixel_mask[:, None]

    out = dict(batch)
    out['pixel_values'] = pixel_values.to(batch['pixel_values'].dtype)
    out['mask_labels'] = mask_labels
    out['pixel_mask'] = pixel_mask
    if 'instance_valid' in batch:
        survives = (mask_labels.sum(dim=(2, 3)) > 0).to(batch['instance_valid'].dtype)
        out['instance_valid'] = batch['instance_valid'] * survives
    return out


def augment_batch(batch: dict, cfg: AugmentConfig | None = None,
                  generator: torch.Generator | None = None,
                  shard: tuple[int, int] | None = None) -> dict:
    """``batch`` augmented with factors drawn from ``generator`` (its rows
    ``shard`` of the global batch's draw); ``batch`` itself when ``cfg``
    enables nothing."""
    cfg = cfg or AugmentConfig()
    if not cfg.any_enabled():
        return batch
    pixels = batch['pixel_values']
    return apply_factors(batch, draw_factors(pixels.shape[0], cfg, generator, pixels.device,
                                             shard), cfg)


def from_env() -> AugmentConfig | None:
    """``WISTPU_AUGMENT=1`` → the default recipe; 0 or unset → None (no
    augmentation, as the reference trains). The knobs: ``WISTPU_AUG_HFLIP``,
    ``WISTPU_AUG_SCALE_PROB``, ``WISTPU_AUG_SCALE_LO`` / ``_HI``,
    ``WISTPU_AUG_BRIGHTNESS``, ``WISTPU_AUG_CONTRAST``."""
    if os.environ.get('WISTPU_AUGMENT', '0') != '1':
        return None
    d = AugmentConfig()
    return AugmentConfig(
        hflip_prob=float(os.environ.get('WISTPU_AUG_HFLIP', d.hflip_prob)),
        scale_prob=float(os.environ.get('WISTPU_AUG_SCALE_PROB', d.scale_prob)),
        scale_range=(float(os.environ.get('WISTPU_AUG_SCALE_LO', d.scale_range[0])),
                     float(os.environ.get('WISTPU_AUG_SCALE_HI', d.scale_range[1]))),
        brightness=float(os.environ.get('WISTPU_AUG_BRIGHTNESS', d.brightness)),
        contrast=float(os.environ.get('WISTPU_AUG_CONTRAST', d.contrast)),
    )
