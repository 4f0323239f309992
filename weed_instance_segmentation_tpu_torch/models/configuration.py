"""Model configurations.

Dataclass twins of HF ``Mask2FormerConfig`` / ``SwinConfig`` and the JAX
package's ``ResNetConfig``, copied by value from
``weed_instance_segmentation_tpu/models/configuration.py`` (importing that
module would run the JAX package's ``__init__``). ``from_json``/``save_json``
read and write the same ``config.json`` as the JAX package (and as an HF
checkpoint). As there, a ResNet config is written without a backbone
``model_type`` and read back only as Swin, so a ResNet model directory does
not reload in either package.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


@dataclasses.dataclass
class ResNetConfig:
    """torchvision-style ResNet with frozen batch norm (detection backbone)."""
    depths: tuple = (3, 4, 6, 3)  # R50
    embed_dim: int = 64
    num_channels: int = 3

    @property
    def channels(self) -> tuple:
        return tuple(self.embed_dim * 4 * 2 ** i for i in range(4))  # (256,512,1024,2048)


# Swin presets (embed_dim / depths / heads / window per official checkpoints).
SWIN_PRESETS = {
    'tiny': dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7),
    'small': dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), window_size=7),
    'base': dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window_size=12),
    'large': dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window_size=12),
}


@dataclasses.dataclass
class Mask2FormerConfig:
    backbone_config: Optional[SwinConfig | ResNetConfig] = None
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
    def resnet50(cls, **kwargs) -> 'Mask2FormerConfig':
        return cls(backbone_config=ResNetConfig(), **kwargs)

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

    @classmethod
    def from_json(cls, path: str) -> 'Mask2FormerConfig':
        """Load from a checkpoint directory's ``config.json`` (or the file)."""
        cfg_file = path if path.endswith('.json') else os.path.join(path, 'config.json')
        with open(cfg_file) as f:
            raw = json.load(f)
        return cls.from_hf_dict(raw)

    @classmethod
    def from_hf_dict(cls, raw: dict) -> 'Mask2FormerConfig':
        bb = raw.get('backbone_config') or {}
        if bb.get('model_type', 'swin') != 'swin':
            raise ValueError(f'Unsupported backbone model_type {bb.get("model_type")!r}')
        backbone = SwinConfig(
            image_size=bb.get('image_size', 224),
            patch_size=bb.get('patch_size', 4),
            embed_dim=bb.get('embed_dim', 96),
            depths=tuple(bb.get('depths', (2, 2, 18, 2))),
            num_heads=tuple(bb.get('num_heads', (3, 6, 12, 24))),
            window_size=bb.get('window_size', 7),
            mlp_ratio=bb.get('mlp_ratio', 4.0),
            qkv_bias=bb.get('qkv_bias', True),
            drop_path_rate=bb.get('drop_path_rate', 0.3),
            layer_norm_eps=bb.get('layer_norm_eps', 1e-5),
            use_absolute_embeddings=bb.get('use_absolute_embeddings', False),
        )
        id2label = raw.get('id2label')
        if id2label is not None:
            id2label = {int(k): v for k, v in id2label.items()}
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields and k not in
                  ('backbone_config', 'id2label', 'label2id', 'feature_strides')}
        return cls(
            backbone_config=backbone,
            id2label=id2label,
            feature_strides=tuple(raw.get('feature_strides', (4, 8, 16, 32))),
            **kwargs,
        )

    def to_hf_dict(self) -> dict:
        d = dataclasses.asdict(self)
        bb = d.pop('backbone_config')
        if isinstance(self.backbone_config, SwinConfig):
            bb['model_type'] = 'swin'
        d['backbone_config'] = bb
        d['model_type'] = 'mask2former'
        return d

    def save_json(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, 'config.json'), 'w') as f:
            json.dump(self.to_hf_dict(), f, indent=2, default=list)
