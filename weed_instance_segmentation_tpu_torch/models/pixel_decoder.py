"""Mask2Former pixel decoder: multi-scale deformable-attention encoder + FPN
top-up (HF:modeling_mask2former.py:888-1417).

Port of ``weed_instance_segmentation_tpu/models/pixel_decoder.py``. Structure:
1×1 conv + GroupNorm(32) input projections on the 3 highest-stride backbone
features, learned level embeddings, the deformable encoder layers, then one
FPN step fusing the stride-4 stage-1 features and a 1×1 mask projection.

Feature maps are NHWC at the public boundary, as in the JAX package; the
convolutions run NCHW inside. Reference points and sine position embeddings
are shape-derived constants (the HF code builds masks of zeros, so valid
ratios are always 1).

The attention-weight softmax and the sampling locations are formed in the
compute dtype, as the JAX package forms them (so at bf16 a level-0 location is
rounded to 8 mantissa bits), and the MSDA core casts both to float32, as
``ops/msda_fused.py`` does. Under autocast they are formed with autocast off,
in the projections' dtype, so that autocast's float32 ``exp`` and ``sum`` do
not change them.

``remat`` recomputes each encoder layer in the backward except the MSDA
output, which is kept (the JAX ``save_only_these_names('msda_out')`` policy):
the layer runs as two checkpointed regions around the MSDA call.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.position_embedding import sine_position_embedding
from weed_instance_segmentation_tpu_torch.ops.constants import device_constant
from weed_instance_segmentation_tpu_torch.ops.deformable_attention import msda
from weed_instance_segmentation_tpu_torch.ops.resize import interpolate_bilinear


def deform_offsets_bias_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Radial-grid bias init of sampling_offsets (HF:2116-2133)."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 1, 2), (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def reference_points_constant(spatial_shapes: tuple) -> np.ndarray:
    """(L_total, 2) normalized center-of-cell reference points, concatenated
    over levels (HF:1099-1126 with valid_ratios == 1)."""
    pts = []
    for h, w in spatial_shapes:
        ref_y, ref_x = np.meshgrid(
            np.linspace(0.5, h - 0.5, h, dtype=np.float32),
            np.linspace(0.5, w - 0.5, w, dtype=np.float32),
            indexing='ij',
        )
        pts.append(np.stack([ref_x.reshape(-1) / w, ref_y.reshape(-1) / h], -1))
    return np.concatenate(pts, 0)


def _offset_normalizer(spatial_shapes: tuple) -> np.ndarray:
    """(L, 2) per-level (W, H): offsets are in (x, y) pixel units."""
    return np.asarray([[w, h] for h, w in spatial_shapes], np.float32)


def _autocast_off(device_type: str):
    """Autocast turned off where it is on. Where it is off already no
    context is entered, so that ``torch.export`` records no autocast region
    in the serving program."""
    if torch.is_autocast_enabled(device_type):
        return torch.autocast(device_type, enabled=False)
    return contextlib.nullcontext()


class MSDeformAttn(nn.Module):
    """Deformable attention module (HF:888-986): :meth:`sampling_inputs`,
    then :meth:`core`, then ``output_proj`` (``EncoderLayer`` runs the three
    so that remat can keep the core's output)."""

    def __init__(self, embed_dim: int, num_heads: int, n_levels: int, n_points: int):
        super().__init__()
        self.num_heads, self.n_levels, self.n_points = num_heads, n_levels, n_points
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.sampling_offsets = nn.Linear(embed_dim, num_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(embed_dim, num_heads * n_levels * n_points)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    def sampling_inputs(self, hidden_states, position_embeddings, reference_points,
                        spatial_shapes):
        """hidden_states: (B, L, C); reference_points: (L, 2) float32 →
        (value (B, L, heads, C/heads), locations (B, L, heads, levels,
        points, 2), weights (B, L, heads, levels, points)), the locations and
        weights in the projections' dtype."""
        b, seq, dim = hidden_states.shape
        nh, nl, npts = self.num_heads, self.n_levels, self.n_points

        with_pos = hidden_states + position_embeddings
        value = self.value_proj(hidden_states).reshape(b, seq, nh, dim // nh)
        offsets = self.sampling_offsets(with_pos).reshape(b, seq, nh, nl, npts, 2)
        attn = self.attention_weights(with_pos).reshape(b, seq, nh, nl * npts)
        dtype = offsets.dtype
        with _autocast_off(hidden_states.device.type):
            # jax.nn.softmax's steps, each rounded to the compute dtype; no
            # gradient through the max, as there (its backward then takes the
            # same steps)
            attn = torch.exp(attn - attn.amax(dim=-1, keepdim=True).detach())
            attn = (attn / attn.sum(dim=-1, keepdim=True)).reshape(b, seq, nh, nl, npts)
            # sampling locations = ref + offsets / [W_l, H_l]  (HF:963-969)
            normalizer = device_constant(_offset_normalizer, (spatial_shapes,),
                                         hidden_states.device, dtype)
            locations = (reference_points.to(dtype)[None, :, None, None, None, :]
                         + offsets / normalizer[None, None, None, :, None, :])
        return value, locations, attn

    @staticmethod
    def core(value, locations, attn, spatial_shapes):
        """The MSDA sampling sum (float32 coordinates, the value dtype's
        sums), outside autocast, in the span ``model.msda``."""
        with trace.span('model.msda'), _autocast_off(value.device.type):
            return msda(value, spatial_shapes, locations, attn)


class EncoderLayer(nn.Module):
    """Deformable encoder layer: MSDA → LN → FFN(relu) → LN, post-norm
    (HF:988-1075)."""

    def __init__(self, config: Mask2FormerConfig):
        super().__init__()
        dim = config.feature_size
        self.self_attn = MSDeformAttn(dim, config.num_attention_heads,
                                      config.num_feature_levels, config.encoder_n_points)
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, config.encoder_feedforward_dim)
        self.fc2 = nn.Linear(config.encoder_feedforward_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, hidden_states, position_embeddings, reference_points, spatial_shapes,
                remat: bool = False):
        """``remat``: checkpoint everything but the MSDA output."""
        attn = self.self_attn
        if remat and torch.is_grad_enabled():
            sampling = checkpoint(attn.sampling_inputs, hidden_states, position_embeddings,
                                  reference_points, spatial_shapes, use_reentrant=False)
            msda_out = attn.core(*sampling, spatial_shapes)
            return checkpoint(self._after_msda, msda_out, hidden_states, use_reentrant=False)
        sampling = attn.sampling_inputs(hidden_states, position_embeddings, reference_points,
                                        spatial_shapes)
        return self._after_msda(attn.core(*sampling, spatial_shapes), hidden_states)

    def _after_msda(self, msda_out, residual):
        hidden_states = self.self_attn_layer_norm(residual + self.self_attn.output_proj(msda_out))
        residual = hidden_states
        hidden_states = self.fc2(F.relu(self.fc1(hidden_states)))
        return self.final_layer_norm(residual + hidden_states)


def _num_fpn_levels(config: Mask2FormerConfig) -> int:
    stride = min(config.feature_strides[-config.num_feature_levels:])
    return int(np.log2(stride) - np.log2(config.common_stride))


class PixelDecoder(nn.Module):
    """Full pixel decoder. Input: list of 4 NHWC backbone features
    [stage1(4×) .. stage4(32×)]. Output: (mask_features NHWC,
    [multi_scale NHWC × 3] ordered stride 32, 16, 8)."""

    def __init__(self, config: Mask2FormerConfig, in_channels: tuple, remat: bool = False):
        super().__init__()
        self.config = config
        self.remat = remat
        dim = config.feature_size
        nl = config.num_feature_levels
        # input projections on the nl highest-stride features, highest first
        for level, ch in enumerate(in_channels[::-1][:nl]):
            self.add_module(f'input_proj_{level}_conv', nn.Conv2d(ch, dim, 1))
            self.add_module(f'input_proj_{level}_norm', nn.GroupNorm(32, dim, eps=1e-5))
        self.level_embed = nn.Parameter(torch.zeros(nl, dim))
        for i in range(config.encoder_layers):
            self.add_module(f'encoder_layer_{i}', EncoderLayer(config))
        for idx, ch in enumerate(in_channels[:_num_fpn_levels(config)][::-1]):
            self.add_module(f'fpn_lateral_{idx}_conv', nn.Conv2d(ch, dim, 1, bias=False))
            self.add_module(f'fpn_lateral_{idx}_norm', nn.GroupNorm(32, dim, eps=1e-5))
            self.add_module(f'fpn_output_{idx}_conv',
                            nn.Conv2d(dim, dim, 3, padding=1, bias=False))
            self.add_module(f'fpn_output_{idx}_norm', nn.GroupNorm(32, dim, eps=1e-5))
        self.mask_projection = nn.Conv2d(dim, config.mask_feature_size, 1)

    def forward(self, features: list):
        cfg = self.config
        dim = cfg.feature_size
        nl = cfg.num_feature_levels
        b = features[0].shape[0]

        flat, pos, spatial_shapes = [], [], []
        for level, feat in enumerate(features[::-1][:nl]):
            x = getattr(self, f'input_proj_{level}_conv')(feat.permute(0, 3, 1, 2))
            x = getattr(self, f'input_proj_{level}_norm')(x)
            h, w = x.shape[-2:]
            spatial_shapes.append((h, w))
            flat.append(x.flatten(2).transpose(1, 2))
            pe = device_constant(sine_position_embedding, (h, w, dim // 2), x.device, x.dtype)
            pos.append(pe + self.level_embed[level][None])
        spatial_shapes = tuple(spatial_shapes)
        hidden = torch.cat(flat, dim=1)  # (B, L_total, C)
        pos_flat = torch.cat(pos, dim=0)[None]  # (1, L_total, C)
        ref_points = device_constant(reference_points_constant, (spatial_shapes,), hidden.device)

        for i in range(cfg.encoder_layers):
            hidden = getattr(self, f'encoder_layer_{i}')(hidden, pos_flat, ref_points,
                                                          spatial_shapes, self.remat)

        # split back to NHWC maps (ordered stride 32, 16, 8)
        outputs = []
        start = 0
        for h, w in spatial_shapes:
            outputs.append(hidden[:, start:start + h * w].reshape(b, h, w, dim))
            start += h * w

        # FPN levels from the remaining low-stride features, low→high res
        for idx, feat in enumerate(features[:_num_fpn_levels(cfg)][::-1]):
            lateral = getattr(self, f'fpn_lateral_{idx}_conv')(feat.permute(0, 3, 1, 2))
            lateral = getattr(self, f'fpn_lateral_{idx}_norm')(lateral)
            up = interpolate_bilinear(outputs[-1].permute(0, 3, 1, 2), lateral.shape[-2:])
            out = getattr(self, f'fpn_output_{idx}_conv')(lateral + up)
            out = F.relu(getattr(self, f'fpn_output_{idx}_norm')(out))
            outputs.append(out.permute(0, 2, 3, 1))

        mask_features = self.mask_projection(outputs[-1].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return mask_features, outputs[:nl]
