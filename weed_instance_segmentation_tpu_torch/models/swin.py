"""Swin Transformer backbone (NHWC public layout).

Port of ``weed_instance_segmentation_tpu/models/swin.py``, itself at parity
with the HF Swin backbone (``transformers`` ``models/swin/modeling_swin.py``):
patch embed (4×4 conv + LN), stages of window / shifted-window attention with
learned relative-position bias, patch merging, and per-stage output
LayerNorms taken before downsampling. The window size never shrinks; inputs
are padded to window multiples (``always_partition=True``).

Window attention is plain batched ``matmul`` + softmax: the JAX package
computes it in XLA too (its Pallas A/B kernel, ``tools/ab_window_attn.py``,
never shipped). Stochastic depth is a training feature and is not ported yet:
this module computes the deterministic forward.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from weed_instance_segmentation_tpu_torch.models.configuration import SwinConfig
from weed_instance_segmentation_tpu_torch.ops.constants import device_constant


def relative_position_index(window_size: int) -> np.ndarray:
    """Pairwise relative-position index inside a window (SWIN:415-426)."""
    coords = np.stack(np.meshgrid(np.arange(window_size), np.arange(window_size), indexing='ij'))
    coords_flat = coords.reshape(2, -1)
    relative = coords_flat[:, :, None] - coords_flat[:, None, :]
    relative = relative.transpose(1, 2, 0)
    relative[:, :, 0] += window_size - 1
    relative[:, :, 1] += window_size - 1
    relative[:, :, 0] *= 2 * window_size - 1
    return relative.sum(-1)  # (ws^2, ws^2)


def shifted_window_attn_mask(height: int, width: int, window_size: int, shift: int) -> np.ndarray:
    """Additive attention mask for SW-MSA built from 9 region slices, fill
    value −100.0 exactly as HF (SWIN:594-620). Returns (num_windows, ws², ws²)."""
    img_mask = np.zeros((height, width))
    slices = (
        slice(0, -window_size),
        slice(-window_size, -shift),
        slice(-shift, None),
    )
    count = 0
    for hs in slices:
        for ws_ in slices:
            img_mask[hs, ws_] = count
            count += 1
    nh, nw = height // window_size, width // window_size
    windows = img_mask.reshape(nh, window_size, nw, window_size)
    windows = windows.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws², C); H, W divisible by ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, ws², C) → (B, H, W, C)."""
    c = windows.shape[-1]
    x = windows.reshape(-1, h // ws, w // ws, ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def _flat_relative_position_index(window_size: int) -> np.ndarray:
    return relative_position_index(window_size).reshape(-1)


class WindowAttention(nn.Module):
    """W-MSA with learned relative position bias (SWIN:399-491)."""

    def __init__(self, config: SwinConfig, dim: int, num_heads: int):
        super().__init__()
        self.window_size = config.window_size
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim, bias=config.qkv_bias)
        self.key = nn.Linear(dim, dim, bias=config.qkv_bias)
        self.value = nn.Linear(dim, dim, bias=config.qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * self.window_size - 1) ** 2, num_heads)
        )
        self.output_dense = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (windows, tokens, C); attn_mask: (image windows, tokens, tokens)."""
        nw, tokens, dim = x.shape
        heads = self.num_heads
        head_dim = dim // heads

        def split_heads(t):
            return t.reshape(nw, tokens, heads, head_dim).transpose(1, 2)

        q = split_heads(self.query(x))
        k = split_heads(self.key(x))
        v = split_heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim)

        rel_idx = device_constant(_flat_relative_position_index, (self.window_size,), x.device)
        rel_bias = self.relative_position_bias_table[rel_idx].reshape(tokens, tokens, heads)
        scores = scores + rel_bias.permute(2, 0, 1).to(scores.dtype)[None]

        if attn_mask is not None:
            n_img_windows = attn_mask.shape[0]
            scores = scores.reshape(-1, n_img_windows, heads, tokens, tokens)
            scores = scores + attn_mask[None, :, None]
            scores = scores.reshape(-1, heads, tokens, tokens)

        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(nw, tokens, dim)
        return self.output_dense(out)


class SwinBlock(nn.Module):
    """One Swin layer: LN → (S)W-MSA → residual → LN → MLP → residual
    (SWIN:572-694)."""

    def __init__(self, config: SwinConfig, dim: int, num_heads: int, shift_size: int):
        super().__init__()
        self.window_size = config.window_size
        self.shift_size = shift_size
        self.layernorm_before = nn.LayerNorm(dim, eps=config.layer_norm_eps)
        self.attention = WindowAttention(config, dim, num_heads)
        self.layernorm_after = nn.LayerNorm(dim, eps=config.layer_norm_eps)
        self.intermediate_dense = nn.Linear(dim, int(config.mlp_ratio * dim))
        self.output_dense = nn.Linear(int(config.mlp_ratio * dim), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = self.window_size
        _, h, w, _ = x.shape
        shortcut = x

        x = self.layernorm_before(x)
        # pad bottom/right to window multiples (SWIN:622-627)
        pad_b = (ws - h % ws) % ws
        pad_r = (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r

        shift = self.shift_size
        attn_mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            attn_mask = device_constant(shifted_window_attn_mask, (hp, wp, ws, shift),
                                        x.device, x.dtype)

        attn = self.attention(window_partition(x, ws), attn_mask)
        x = window_reverse(attn, ws, hp, wp)

        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :h, :w]
        x = shortcut + x

        y = self.layernorm_after(x)
        y = F.gelu(self.intermediate_dense(y), approximate='none')  # erf-exact
        return x + self.output_dense(y)


class PatchMerging(nn.Module):
    """2×2 patch merging: 4-way slice concat → LN(4C) → Linear(2C, no bias)
    (SWIN:309-361)."""

    def __init__(self, config: SwinConfig, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=config.layer_norm_eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        f0 = x[:, 0::2, 0::2]
        f1 = x[:, 1::2, 0::2]
        f2 = x[:, 0::2, 1::2]
        f3 = x[:, 1::2, 1::2]
        x = torch.cat([f0, f1, f2, f3], dim=-1)
        return self.reduction(self.norm(x))


class SwinBackbone(nn.Module):
    """Backbone returning the 4 per-stage NHWC feature maps, each LayerNormed
    (SWIN:1174-1258, hidden_states_norms at SWIN:1185-1188).

    Submodule names follow the JAX package's flax tree (``stage{s}_block{b}``,
    ``downsample{s}``, ``stage{k}_norm``), so ``models.convert`` maps its
    params by name."""

    def __init__(self, config: SwinConfig):
        super().__init__()
        self.config = config
        ps = config.patch_size
        self.patch_embed = nn.Conv2d(config.num_channels, config.embed_dim, ps, stride=ps)
        self.embed_norm = nn.LayerNorm(config.embed_dim, eps=config.layer_norm_eps)
        num_stages = len(config.depths)
        for stage in range(num_stages):
            dim = int(config.embed_dim * 2 ** stage)
            for blk in range(config.depths[stage]):
                shift = 0 if blk % 2 == 0 else config.window_size // 2
                self.add_module(f'stage{stage}_block{blk}',
                                SwinBlock(config, dim, config.num_heads[stage], shift))
            self.add_module(f'stage{stage + 1}_norm', nn.LayerNorm(dim, eps=1e-5))
            if stage < num_stages - 1:
                self.add_module(f'downsample{stage}', PatchMerging(config, dim))

    def forward(self, pixel_values: torch.Tensor) -> list:
        """pixel_values: (B, H, W, 3) NHWC. Returns [stage1..stage4] NHWC."""
        cfg = self.config
        ps = cfg.patch_size
        _, h, w, _ = pixel_values.shape
        pad_b = (ps - h % ps) % ps
        pad_r = (ps - w % ps) % ps
        if pad_b or pad_r:
            pixel_values = F.pad(pixel_values, (0, 0, 0, pad_r, 0, pad_b))
        x = self.patch_embed(pixel_values.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.embed_norm(x)

        features = []
        num_stages = len(cfg.depths)
        for stage in range(num_stages):
            for blk in range(cfg.depths[stage]):
                x = getattr(self, f'stage{stage}_block{blk}')(x)
            # out-feature norm on the before-downsampling states
            features.append(getattr(self, f'stage{stage + 1}_norm')(x))
            if stage < num_stages - 1:
                x = getattr(self, f'downsample{stage}')(x)
        return features
