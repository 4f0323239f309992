"""2D sine position embedding (HF:modeling_mask2former.py:842-887).

With no pixel mask (the HF pixel/transformer modules always pass
``mask=None``), the embedding is a pure function of the (H, W) shape, so it is
built once in numpy.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=64)
def sine_position_embedding(
    height: int,
    width: int,
    num_pos_feats: int = 128,
    temperature: int = 10000,
    normalize: bool = True,
) -> np.ndarray:
    """Returns (H*W, 2*num_pos_feats) float32, channels ordered [y | x],
    flattened row-major — matching HF's NCHW output flattened with
    ``flatten(2).transpose(1, 2)``."""
    scale = 2 * math.pi
    not_mask = np.ones((height, width), dtype=np.float32)
    y_embed = not_mask.cumsum(0)
    x_embed = not_mask.cumsum(1)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * np.floor(dim_t / 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack((np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])), axis=3).reshape(
        height, width, -1
    )
    pos_y = np.stack((np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])), axis=3).reshape(
        height, width, -1
    )
    pos = np.concatenate((pos_y, pos_x), axis=2)  # (H, W, 2*num_pos_feats)
    return pos.reshape(height * width, -1).astype(np.float32)
