"""Bilinear grid sampling and HF's ``point_sample``.

Port of ``weed_instance_segmentation_tpu/ops/grid_sample.py``:
``mode='bilinear', padding_mode='zeros', align_corners=False``, the call the
HF matcher and loss make (HF:modeling_mask2former.py:96-126). The JAX package
computes it outside any Pallas kernel, so here it is ``F.grid_sample``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """value (N, C, H, W), grid (N, Hg, Wg, 2) in [-1, 1] as (x, y) →
    (N, C, Hg, Wg)."""
    return F.grid_sample(value, grid, mode='bilinear', padding_mode='zeros',
                         align_corners=False)


def sample_points(mask: torch.Tensor, point_coordinates: torch.Tensor) -> torch.Tensor:
    """HF ``sample_point``: (N, C, H, W) at [0, 1] point coords (N, P, 2)
    (x, y) → (N, C, P)."""
    grid = 2.0 * point_coordinates - 1.0
    return grid_sample_bilinear(mask, grid[:, None])[:, :, 0, :]
