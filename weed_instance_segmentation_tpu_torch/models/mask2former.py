"""Full Mask2Former model: backbone → pixel decoder → masked-attention
transformer decoder → class/mask heads.

Port of ``weed_instance_segmentation_tpu/models/mask2former.py`` (HF
``Mask2FormerForUniversalSegmentation``, HF:modeling_mask2former.py:2164-2470):
the class predictor is one Linear (hidden → num_labels + 1) applied to every
intermediate layernormed decoder state; per-layer mask logits come from the
transformer module.

API: NCHW ``pixel_values`` like the reference, transposed once to NHWC
inside. The model computes in the dtype of its parameters, or under the
caller's autocast. The backbone is Swin or ResNet, by the config's type.
``remat`` recomputes activations in the backward, as the JAX model's: True =
Swin blocks and deformable encoder layers, 'encoder' = encoder layers only,
False = store everything (the ResNet backbone takes none, as in the JAX
package). The forward's three stages are the spans ``model.backbone``,
``model.pixel_decoder`` and ``model.decoder`` (the heads included;
``engine/trace.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.models.configuration import (
    Mask2FormerConfig, ResNetConfig, SwinConfig,
)
from weed_instance_segmentation_tpu_torch.models.pixel_decoder import PixelDecoder
from weed_instance_segmentation_tpu_torch.models.resnet import ResNetBackbone
from weed_instance_segmentation_tpu_torch.models.swin import SwinBackbone
from weed_instance_segmentation_tpu_torch.models.transformer_decoder import TransformerModule


class Mask2FormerOutput(NamedTuple):
    """class/mask logits for the final layer + all aux layers.

    class_queries_logits: (B, Q, num_labels+1) — final layer
    masks_queries_logits: (B, Q, H/4, W/4)     — final layer
    aux_class_queries_logits: tuple over intermediate layers (excl. final)
    aux_masks_queries_logits: tuple over intermediate layers (excl. final)
    """

    class_queries_logits: Any
    masks_queries_logits: Any
    aux_class_queries_logits: tuple
    aux_masks_queries_logits: tuple


class Mask2Former(nn.Module):
    def __init__(self, config: Mask2FormerConfig, remat: bool | str = False):
        super().__init__()
        if remat not in (True, False, 'encoder'):
            raise ValueError(f'remat must be True, False or \'encoder\', got {remat!r}')
        if isinstance(config.backbone_config, SwinConfig):
            self.backbone = SwinBackbone(config.backbone_config, remat=remat is True)
        elif isinstance(config.backbone_config, ResNetConfig):
            self.backbone = ResNetBackbone(config.backbone_config)
        else:
            raise ValueError(f'Unsupported backbone config {type(config.backbone_config)}')
        self.config = config
        self.pixel_decoder = PixelDecoder(config, config.backbone_config.channels,
                                          remat=bool(remat))
        self.transformer_module = TransformerModule(config)
        self.class_predictor = nn.Linear(config.hidden_dim, config.num_labels + 1)

    def forward(self, pixel_values: torch.Tensor, generator: torch.Generator | None = None,
                shard: tuple[int, int] | None = None) -> Mask2FormerOutput:
        """pixel_values: (B, 3, H, W) float — reference/HF layout.
        ``generator`` draws the backbone's drop-path masks in training mode;
        ``shard`` (a data rank's (index, count)) keeps the rank's part of
        the global batch's draw."""
        dtype = self.class_predictor.weight.dtype
        x = pixel_values.permute(0, 2, 3, 1).to(dtype)  # NHWC
        with trace.span('model.backbone'):
            features = self.backbone(x, generator, shard)
        with trace.span('model.pixel_decoder'):
            mask_features, multi_scale = self.pixel_decoder(features)
        with trace.span('model.decoder'):
            intermediate, mask_logits = self.transformer_module(multi_scale, mask_features)
            class_logits = tuple(self.class_predictor(h) for h in intermediate)
        return Mask2FormerOutput(
            class_queries_logits=class_logits[-1],
            masks_queries_logits=mask_logits[-1],
            aux_class_queries_logits=class_logits[:-1],
            aux_masks_queries_logits=mask_logits[:-1],
        )
