"""Swin Transformer backbone (NHWC public layout).

Port of ``weed_instance_segmentation_tpu/models/swin.py``, itself at parity
with the HF Swin backbone (``transformers`` ``models/swin/modeling_swin.py``):
patch embed (4×4 conv + LN), stages of window / shifted-window attention with
learned relative-position bias, patch merging, and per-stage output
LayerNorms taken before downsampling. The window size never shrinks; inputs
are padded to window multiples (``always_partition=True``).

Window attention goes through ``ops/window_attention.py``: the CUDA kernel
(port of the Pallas kernel ``tools/ab_window_attn.py``, with the shift mask)
on the card, its plain version on the CPU.

Training adds stochastic depth (per-sample drop path, rates spread by
``linspace`` over the blocks) and ``remat``: each block is recomputed in the
backward (``torch.utils.checkpoint``). The drop-path masks are drawn outside
the checkpointed block and passed in, so the recompute sees the same masks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from weed_instance_segmentation_tpu_torch.models.configuration import SwinConfig
from weed_instance_segmentation_tpu_torch.ops.constants import device_constant
from weed_instance_segmentation_tpu_torch.ops.window_attention import window_attention
from weed_instance_segmentation_tpu_torch.parallel.mesh import rand_rows


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
        self.dropout = config.attention_probs_dropout_prob
        self.query = nn.Linear(dim, dim, bias=config.qkv_bias)
        self.key = nn.Linear(dim, dim, bias=config.qkv_bias)
        self.value = nn.Linear(dim, dim, bias=config.qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * self.window_size - 1) ** 2, num_heads)
        )
        self.output_dense = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (windows, tokens, C); attn_mask: (image windows, tokens, tokens)."""
        if self.training and self.dropout:
            raise NotImplementedError(f'attention dropout {self.dropout} is not ported: '
                                      'the window-attention kernel has none')
        nw, tokens, dim = x.shape
        heads = self.num_heads
        head_dim = dim // heads

        def split_heads(t):
            return t.reshape(nw, tokens, heads, head_dim).transpose(1, 2).contiguous()

        rel_idx = device_constant(_flat_relative_position_index, (self.window_size,), x.device)
        rel_bias = self.relative_position_bias_table[rel_idx].reshape(tokens, tokens, heads)
        out = window_attention(split_heads(self.query(x)), split_heads(self.key(x)),
                               split_heads(self.value(x)),
                               rel_bias.permute(2, 0, 1).float().contiguous(), attn_mask)
        return self.output_dense(out.transpose(1, 2).reshape(nw, tokens, dim))


class SwinBlock(nn.Module):
    """One Swin layer: LN → (S)W-MSA → residual → LN → MLP → residual
    (SWIN:572-694)."""

    def __init__(self, config: SwinConfig, dim: int, num_heads: int, shift_size: int,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.window_size = config.window_size
        self.shift_size = shift_size
        self.drop_path_rate = drop_path_rate
        self.dropout = config.hidden_dropout_prob
        self.layernorm_before = nn.LayerNorm(dim, eps=config.layer_norm_eps)
        self.attention = WindowAttention(config, dim, num_heads)
        self.layernorm_after = nn.LayerNorm(dim, eps=config.layer_norm_eps)
        self.intermediate_dense = nn.Linear(dim, int(config.mlp_ratio * dim))
        self.output_dense = nn.Linear(int(config.mlp_ratio * dim), dim)

    def drop_path_scales(self, batch: int, device: torch.device,
                         generator: Optional[torch.Generator],
                         shard: Optional[tuple[int, int]] = None) -> Optional[torch.Tensor]:
        """Stochastic depth (JAX ``SwinBlock._drop_path``): (2, batch) float32
        per-sample scales, keep/(1 − rate) or 0, for the attention and MLP
        branches; None when the block keeps every path (eval, or rate 0).
        ``shard`` takes a data rank's columns of the global draw
        (``parallel/mesh.py::rand_rows``)."""
        rate = self.drop_path_rate
        if not self.training or rate == 0.0:
            return None
        keep = 1.0 - rate
        draw = rand_rows((2, batch), generator, device, shard, dim=1)
        return (draw < keep).float() / keep

    def forward(self, x: torch.Tensor, drop_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, H, W, C); ``drop_scales`` from :meth:`drop_path_scales`."""
        if self.training and self.dropout:
            raise NotImplementedError(f'hidden dropout {self.dropout} is not ported')
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
                                        x.device, torch.float32)

        attn = self.attention(window_partition(x, ws), attn_mask)
        x = window_reverse(attn, ws, hp, wp)

        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :h, :w]
        if drop_scales is not None:
            x = x * drop_scales[0, :, None, None, None].to(x.dtype)
        x = shortcut + x

        y = self.layernorm_after(x)
        y = self.output_dense(F.gelu(self.intermediate_dense(y), approximate='none'))  # erf-exact
        if drop_scales is not None:
            y = y * drop_scales[1, :, None, None, None].to(y.dtype)
        return x + y


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

    def __init__(self, config: SwinConfig, remat: bool = False):
        super().__init__()
        self.config = config
        self.remat = remat
        ps = config.patch_size
        self.patch_embed = nn.Conv2d(config.num_channels, config.embed_dim, ps, stride=ps)
        self.embed_norm = nn.LayerNorm(config.embed_dim, eps=config.layer_norm_eps)
        num_stages = len(config.depths)
        # stochastic depth schedule (SWIN:732)
        rates = iter(np.linspace(0, config.drop_path_rate, sum(config.depths)))
        for stage in range(num_stages):
            dim = int(config.embed_dim * 2 ** stage)
            for blk in range(config.depths[stage]):
                shift = 0 if blk % 2 == 0 else config.window_size // 2
                self.add_module(f'stage{stage}_block{blk}',
                                SwinBlock(config, dim, config.num_heads[stage], shift,
                                          float(next(rates))))
            self.add_module(f'stage{stage + 1}_norm', nn.LayerNorm(dim, eps=1e-5))
            if stage < num_stages - 1:
                self.add_module(f'downsample{stage}', PatchMerging(config, dim))

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                shard: Optional[tuple[int, int]] = None) -> list:
        """pixel_values: (B, H, W, 3) NHWC. Returns [stage1..stage4] NHWC.
        ``generator`` draws the drop-path masks in training mode, the
        columns ``shard`` names of a data-parallel run's global draw."""
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
                block = getattr(self, f'stage{stage}_block{blk}')
                scales = block.drop_path_scales(x.shape[0], x.device, generator, shard)
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(block, x, scales, use_reentrant=False)
                else:
                    x = block(x, scales)
            # out-feature norm on the before-downsampling states
            features.append(getattr(self, f'stage{stage + 1}_norm')(x))
            if stage < num_stages - 1:
                x = getattr(self, f'downsample{stage}')(x)
        return features
