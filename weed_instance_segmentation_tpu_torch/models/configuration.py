"""Model configurations.

Dataclass twins of HF ``Mask2FormerConfig`` / ``SwinConfig``, copied by value
from ``weed_instance_segmentation_tpu/models/configuration.py`` (importing that
module would run the JAX package's ``__init__``). Only the Swin backbone is
ported so far.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SwinConfig:
    image_size: int = 224
    num_channels: int = 3
    patch_size: int = 4
    embed_dim: int = 96
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    drop_path_rate: float = 0.3
    hidden_act: str = 'gelu'
    layer_norm_eps: float = 1e-5
    use_absolute_embeddings: bool = False
    out_features: tuple = ('stage1', 'stage2', 'stage3', 'stage4')

    @property
    def num_features(self) -> tuple:
        return tuple(int(self.embed_dim * 2 ** i) for i in range(len(self.depths)))

    @property
    def channels(self) -> tuple:
        """Output channels per out_feature (stage1..4)."""
        return self.num_features


# Swin presets (embed_dim / depths / heads / window per official checkpoints).
SWIN_PRESETS = {
    'tiny': dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7),
    'small': dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), window_size=7),
    'base': dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window_size=12),
    'large': dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window_size=12),
}


@dataclasses.dataclass
class Mask2FormerConfig:
    backbone_config: Optional[SwinConfig] = None
    feature_size: int = 256
    mask_feature_size: int = 256
    hidden_dim: int = 256
    encoder_feedforward_dim: int = 1024
    activation_function: str = 'relu'
    encoder_layers: int = 6
    decoder_layers: int = 10
    num_attention_heads: int = 8
    dropout: float = 0.0
    dim_feedforward: int = 2048
    pre_norm: bool = False
    enforce_input_projection: bool = False
    common_stride: int = 4
    ignore_value: int = 255
    num_queries: int = 100
    no_object_weight: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    init_std: float = 0.02
    init_xavier_std: float = 1.0
    use_auxiliary_loss: bool = True
    feature_strides: tuple = (4, 8, 16, 32)
    num_labels: int = 2
    id2label: Optional[dict] = None
    label2id: Optional[dict] = None
    # pixel decoder / transformer module constants (HF hardcodes both to 3)
    num_feature_levels: int = 3
    encoder_n_points: int = 4

    def __post_init__(self):
        if self.backbone_config is None:
            self.backbone_config = SwinConfig()
        if self.id2label is not None:
            self.num_labels = len(self.id2label)
            if self.label2id is None:
                self.label2id = {v: k for k, v in self.id2label.items()}

    @classmethod
    def swin(cls, variant: str = 'large', **kwargs) -> 'Mask2FormerConfig':
        preset = SWIN_PRESETS[variant]
        num_queries = kwargs.pop('num_queries', 200 if variant in ('base', 'large') else 100)
        return cls(backbone_config=SwinConfig(**preset), num_queries=num_queries, **kwargs)

    @classmethod
    def tiny_test(cls, **kwargs) -> 'Mask2FormerConfig':
        """Small config for fast unit tests."""
        defaults = dict(
            backbone_config=SwinConfig(
                embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2), window_size=4,
                drop_path_rate=0.0,
            ),
            feature_size=32, mask_feature_size=32, hidden_dim=32,
            encoder_feedforward_dim=32, dim_feedforward=64,
            encoder_layers=2, decoder_layers=4, num_attention_heads=2,
            num_queries=10, train_num_points=64,
        )
        defaults.update(kwargs)
        return cls(**defaults)
