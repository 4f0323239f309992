"""Multi-scale deformable attention (MSDA) sampling core, plain PyTorch.

Same contract as ``weed_instance_segmentation_tpu/ops/deformable_attention.py
::msda_reference`` and the forward of ``ops/msda_select.py::msda``, with the
numerics of HF ``multi_scale_deformable_attention``
(HF:modeling_mask2former.py:799-838): per level, a bilinear sample of the
per-head value maps at the sampling locations (``align_corners=False``, zero
padding), then a weighted sum over levels × points.

Formulation: one flat value table over (batch·head·level) and one row gather
per bilinear corner, as ``ops/msda_fused.py`` does. Sampling coordinates and
attention weights are taken in float32 even when the values are bf16 (bf16's
8 mantissa bits would move a level-0 tap by up to half a pixel), and the sum
is accumulated in float32. The JAX package has no Pallas kernel for MSDA; a
hand-written Hopper kernel is queued in ROADMAP.md.
"""

from __future__ import annotations

import torch


def msda(
    value: torch.Tensor,
    spatial_shapes: tuple,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """
    Args:
        value: (B, L_total, heads, head_dim) — per-level feature maps
            flattened and concatenated along L_total.
        spatial_shapes: tuple of (H_l, W_l) per level.
        sampling_locations: (B, Q, heads, levels, points, 2), normalized
            [0, 1] (x, y).
        attention_weights: (B, Q, heads, levels, points), softmaxed over
            levels × points.
    Returns:
        (B, Q, heads * head_dim) in ``value.dtype``.
    """
    b, l_total, heads, head_dim = value.shape
    _, q, _, _, points, _ = sampling_locations.shape

    # flat table: row (bi·heads + h)·L_total + level_off + y·W + x
    table = value.transpose(1, 2).reshape(b * heads * l_total, head_dim)
    bh_base = (torch.arange(b * heads, device=value.device) * l_total).reshape(b, 1, heads, 1)

    locations = sampling_locations.float()
    weights = attention_weights.float()

    out = torch.zeros((b, q, heads, head_dim), dtype=torch.float32, device=value.device)
    level_off = 0
    for level, (hl, wl) in enumerate(spatial_shapes):
        loc = locations[:, :, :, level]  # (B, Q, heads, P, 2)
        # grid_sample unnormalize (align_corners=False)
        x = loc[..., 0] * wl - 0.5
        y = loc[..., 1] * hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx1 = x - x0
        wy1 = y - y0
        base = bh_base + level_off
        level_w = weights[:, :, :, level]
        for dy in (0, 1):
            iy = y0 + dy
            yw = wy1 if dy else 1.0 - wy1
            y_ok = (iy >= 0) & (iy <= hl - 1)
            row = iy.clamp(0, hl - 1).long() * wl
            for dx in (0, 1):
                ix = x0 + dx
                xw = wx1 if dx else 1.0 - wx1
                valid = y_ok & (ix >= 0) & (ix <= wl - 1)
                idx = base + row + ix.clamp(0, wl - 1).long()
                rows = table[idx.reshape(-1)].reshape(b, q, heads, points, head_dim)
                wgt = xw * yw * valid * level_w  # (B, Q, heads, P) f32
                out += torch.einsum('bqhpd,bqhp->bqhd', rows.float(), wgt)
        level_off += hl * wl

    return out.to(value.dtype).reshape(b, q, heads * head_dim)
