"""ResNet backbone with frozen batch norm (NHWC in, NHWC stage features out).

Port of ``weed_instance_segmentation_tpu/models/resnet.py``: the
torchvision/detectron2 bottleneck ResNet (R50: depths 3-4-6-3, width 64)
with FrozenBatchNorm, whose four statistics are parameters that no batch
updates, so the backbone is a pure function of its input. It takes no drop
path and no remat, as in the JAX package.

Module attributes carry the flax tree's names (``stem_conv``, ``stem_bn``,
``stage{s}_block{b}.conv1…conv3/bn1…bn3/downsample_conv/downsample_bn``, and
``scale``, ``bias``, ``mean``, ``var`` in each norm), so
``models/convert.py`` maps the parameters by name. The convolutions run on
channels-last NCHW tensors, and each stage's output is handed back as an
NHWC view of that memory, as the Swin backbone hands its features to the
pixel decoder. flax ``nn.Conv``'s default ``'SAME'`` padding of the 1×1
convolutions (the stride-2 ``downsample_conv`` too) pads nothing, and
``max_pool`` pads with −inf, as ``F.max_pool2d`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from weed_instance_segmentation_tpu_torch.models.configuration import ResNetConfig


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * scale + bias over the channels of
    an NCHW ``x``, in ``x``'s dtype, folded as the JAX module folds it: the
    factor ``scale / sqrt(var + eps)`` is formed in float32 and rounded to
    that dtype, the shift ``bias - mean * factor`` is formed in float32
    from the rounded factor and then rounded."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = (self.scale.float() / torch.sqrt(self.var.float() + self.eps)).to(x.dtype)
        shift = (self.bias.float() - self.mean.float() * inv.float()).to(x.dtype)
        return x * inv[:, None, None] + shift[:, None, None]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, mid, 1), FrozenBatchNorm(mid)
        self.conv2, self.bn2 = _conv(mid, mid, 3, stride), FrozenBatchNorm(mid)
        self.conv3, self.bn3 = _conv(mid, out, 1), FrozenBatchNorm(out)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(cin, out, 1, stride)
            self.downsample_bn = FrozenBatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(y + identity)


class ResNetBackbone(nn.Module):
    """The 4 stage feature maps (strides 4/8/16/32), NHWC."""

    def __init__(self, config: ResNetConfig):
        super().__init__()
        self.config = config
        width = config.embed_dim
        self.stem_conv = _conv(config.num_channels, width, 7, 2)
        self.stem_bn = FrozenBatchNorm(width)
        cin = width
        for stage, depth in enumerate(config.depths):
            mid = width * 2 ** stage
            for blk in range(depth):
                self.add_module(f'stage{stage}_block{blk}', Bottleneck(
                    cin, mid, mid * 4, 2 if blk == 0 and stage > 0 else 1, blk == 0))
                cin = mid * 4

    def forward(self, pixel_values: torch.Tensor,
                generator: torch.Generator | None = None) -> list:
        """pixel_values: (B, H, W, C) NHWC. Returns [stage1..stage4] NHWC.
        ``generator`` is taken for the backbone interface and unused: no
        drop path."""
        x = pixel_values.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        features = []
        for stage, depth in enumerate(self.config.depths):
            for blk in range(depth):
                x = getattr(self, f'stage{stage}_block{blk}')(x)
            features.append(x.permute(0, 2, 3, 1))
        return features
