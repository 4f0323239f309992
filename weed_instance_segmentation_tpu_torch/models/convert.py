"""JAX package flax params ↔ this package's ``state_dict``.

The port's module attributes follow the flax tree's names
(``backbone.stage0_block1.attention.query``,
``pixel_decoder.encoder_layer_3.self_attn.sampling_offsets``,
``transformer_module.layer_8.cross_attn.q_proj``, …), so the conversion is a
flatten plus three layout rules:

- Dense ``kernel`` (in, out) → Linear ``weight`` (out, in);
- Conv ``kernel`` HWIO → Conv2d ``weight`` OIHW;
- LayerNorm/GroupNorm ``scale`` → ``weight`` (a ResNet FrozenBatchNorm keeps
  ``scale``, ``bias``, ``mean`` and ``var``).

Every other leaf (biases, ``relative_position_bias_table``, ``level_embed``,
the query embeddings) keeps its name and layout. Load the result with
``model.load_state_dict(sd, strict=True)``, which raises on any key left
unfilled or unused. :func:`state_dict_to_jax` is the inverse (every 1-D
``weight`` in this model is a norm's scale), so gradients and updated
parameters can be compared with the JAX package's leaf by leaf.

HF checkpoints (``Mask2FormerForUniversalSegmentation``, the
``transformers==4.57.6`` layout) load through :func:`load_hf_checkpoint`:
:func:`convert_hf_state_dict` maps the HF names onto the flax tree, copied by
value from ``weed_instance_segmentation_tpu/models/convert.py`` (torch
``Linear`` (out, in) → flax (in, out), Conv OIHW → HWIO, norm ``weight`` →
``scale``, the decoder's packed ``in_proj`` split in thirds), and
:func:`params_from_jax` turns that tree into this package's ``state_dict``.
``model.safetensors`` is read by :func:`read_safetensors`, a reader of the
format's few rules, since the ``safetensors`` package is not a dependency.
"""

from __future__ import annotations

import json
import os
import re
from collections.abc import Mapping

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.models.configuration import (
    Mask2FormerConfig, SwinConfig,
)


# a ResNet FrozenBatchNorm (``stem_bn``, ``bn1``…``bn3``, ``downsample_bn``):
# its ``scale``, ``bias``, ``mean`` and ``var`` keep their flax names
_FROZEN_BN = re.compile(r'(^|_)bn\d*$')


def _leaf(name: str, value: np.ndarray, parent: str = '') -> tuple[str, np.ndarray]:
    if name == 'kernel':
        if value.ndim == 2:
            return 'weight', value.T
        if value.ndim == 4:
            return 'weight', value.transpose(3, 2, 0, 1)
        raise ValueError(f'kernel of rank {value.ndim} has no torch layout rule')
    if name == 'scale' and not _FROZEN_BN.search(parent):
        return 'weight', value
    return name, value


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested flax param tree (numpy or array-like leaves) → flat state_dict.

    Every leaf becomes exactly one entry; a leaf with no layout rule raises.
    """
    state_dict: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str, parent: str) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f'{prefix}{key}.', key)
                continue
            name, array = _leaf(key, np.asarray(value), parent)
            full = prefix + name
            if full in state_dict:
                raise ValueError(f'two flax leaves map to {full!r}')
            state_dict[full] = torch.from_numpy(np.ascontiguousarray(array).copy())

    walk(params, '', '')
    return state_dict


def flax_path(full: str, ndim: int) -> list[str]:
    """The flax path of the ``state_dict`` entry ``full`` of rank ``ndim``."""
    *path, name = full.split('.')
    if name == 'weight':
        if ndim not in (1, 2, 4):
            raise ValueError(f'weight of rank {ndim} has no flax layout rule')
        name = 'scale' if ndim == 1 else 'kernel'
    return path + [name]


def flax_leaf(full: str, tensor: torch.Tensor) -> tuple[list[str], np.ndarray]:
    """One ``state_dict`` entry (or a tensor of a parameter's shape keyed by
    its name: a gradient, an optimizer moment) → (flax path, float32 numpy
    array in the flax layout)."""
    value = tensor.detach().cpu().float().numpy()
    path = flax_path(full, value.ndim)
    if path[-1] == 'kernel':
        value = value.T if value.ndim == 2 else value.transpose(2, 3, 1, 0)
    return path, np.ascontiguousarray(value)


def torch_leaf(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """The inverse of :func:`flax_leaf` for one leaf: flax path joined by
    '/' → (``state_dict`` name, array in the torch layout)."""
    *prefix, name = path.split('/')
    name, array = _leaf(name, np.asarray(value), prefix[-1] if prefix else '')
    return '.'.join(prefix + [name]), array


def state_dict_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Flat ``state_dict`` (or gradients keyed the same way) → nested flax
    tree of float32 numpy arrays; the inverse of :func:`params_from_jax`."""
    tree: dict = {}
    for full, tensor in state_dict.items():
        (*path, name), value = flax_leaf(full, tensor)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        if name in node:
            raise ValueError(f'two entries map to the flax leaf {full!r}')
        node[name] = value
    return tree


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

def _lin(sd, name):
    return {'kernel': sd[f'{name}.weight'].T, 'bias': sd[f'{name}.bias']}


def _lin_nobias(sd, name):
    return {'kernel': sd[f'{name}.weight'].T}


def _conv(sd, name, bias=True):
    out = {'kernel': sd[f'{name}.weight'].transpose(2, 3, 1, 0)}
    if bias:
        out['bias'] = sd[f'{name}.bias']
    return out


def _norm(sd, name):
    return {'scale': sd[f'{name}.weight'], 'bias': sd[f'{name}.bias']}


def convert_swin_backbone(sd: dict, cfg: SwinConfig, prefix: str = '') -> dict:
    """A HF ``SwinBackbone`` state dict subtree (numpy values) → flax tree."""
    p = prefix
    params = {
        'patch_embed': _conv(sd, f'{p}embeddings.patch_embeddings.projection'),
        'embed_norm': _norm(sd, f'{p}embeddings.norm'),
    }
    for s in range(len(cfg.depths)):
        for b in range(cfg.depths[s]):
            bp = f'{p}encoder.layers.{s}.blocks.{b}'
            params[f'stage{s}_block{b}'] = {
                'layernorm_before': _norm(sd, f'{bp}.layernorm_before'),
                'layernorm_after': _norm(sd, f'{bp}.layernorm_after'),
                'attention': {
                    'query': _lin(sd, f'{bp}.attention.self.query'),
                    'key': _lin(sd, f'{bp}.attention.self.key'),
                    'value': _lin(sd, f'{bp}.attention.self.value'),
                    'output_dense': _lin(sd, f'{bp}.attention.output.dense'),
                    'relative_position_bias_table': sd[
                        f'{bp}.attention.self.relative_position_bias_table'
                    ],
                },
                'intermediate_dense': _lin(sd, f'{bp}.intermediate.dense'),
                'output_dense': _lin(sd, f'{bp}.output.dense'),
            }
        if s < len(cfg.depths) - 1:
            dp = f'{p}encoder.layers.{s}.downsample'
            params[f'downsample{s}'] = {
                'norm': _norm(sd, f'{dp}.norm'),
                'reduction': _lin_nobias(sd, f'{dp}.reduction'),
            }
    for k in range(1, len(cfg.depths) + 1):
        params[f'stage{k}_norm'] = _norm(sd, f'{p}hidden_states_norms.stage{k}')
    return params


def convert_pixel_decoder(sd: dict, cfg: Mask2FormerConfig, prefix: str) -> dict:
    p = prefix
    params = {'level_embed': sd[f'{p}level_embed']}
    for level in range(cfg.num_feature_levels):
        params[f'input_proj_{level}_conv'] = _conv(sd, f'{p}input_projections.{level}.0')
        params[f'input_proj_{level}_norm'] = _norm(sd, f'{p}input_projections.{level}.1')
    for i in range(cfg.encoder_layers):
        lp = f'{p}encoder.layers.{i}'
        params[f'encoder_layer_{i}'] = {
            'self_attn': {
                'sampling_offsets': _lin(sd, f'{lp}.self_attn.sampling_offsets'),
                'attention_weights': _lin(sd, f'{lp}.self_attn.attention_weights'),
                'value_proj': _lin(sd, f'{lp}.self_attn.value_proj'),
                'output_proj': _lin(sd, f'{lp}.self_attn.output_proj'),
            },
            'self_attn_layer_norm': _norm(sd, f'{lp}.self_attn_layer_norm'),
            'final_layer_norm': _norm(sd, f'{lp}.final_layer_norm'),
            'fc1': _lin(sd, f'{lp}.fc1'),
            'fc2': _lin(sd, f'{lp}.fc2'),
        }
    # FPN: HF names adapter_{k}/layer_{k}, k from 1, low to high stride
    stride = min(cfg.feature_strides[-cfg.num_feature_levels:])
    num_fpn = int(np.log2(stride) - np.log2(cfg.common_stride))
    for idx in range(num_fpn):
        params[f'fpn_lateral_{idx}_conv'] = _conv(sd, f'{p}adapter_{idx + 1}.0', bias=False)
        params[f'fpn_lateral_{idx}_norm'] = _norm(sd, f'{p}adapter_{idx + 1}.1')
        params[f'fpn_output_{idx}_conv'] = _conv(sd, f'{p}layer_{idx + 1}.0', bias=False)
        params[f'fpn_output_{idx}_norm'] = _norm(sd, f'{p}layer_{idx + 1}.1')
    params['mask_projection'] = _conv(sd, f'{p}mask_projection')
    return params


def convert_transformer_module(sd: dict, cfg: Mask2FormerConfig, prefix: str) -> dict:
    p = prefix
    params = {
        'level_embed': sd[f'{p}level_embed.weight'],
        'queries_embedder': sd[f'{p}queries_embedder.weight'],
        'queries_features': sd[f'{p}queries_features.weight'],
        'layernorm': _norm(sd, f'{p}decoder.layernorm'),
        'mask_predictor': {
            f'mask_embedder_{i}': _lin(sd, f'{p}decoder.mask_predictor.mask_embedder.{i}.0')
            for i in range(3)
        },
    }
    dim = cfg.hidden_dim
    for i in range(cfg.decoder_layers - 1):
        lp = f'{p}decoder.layers.{i}'
        in_proj_w = sd[f'{lp}.cross_attn.in_proj_weight']
        in_proj_b = sd[f'{lp}.cross_attn.in_proj_bias']
        params[f'layer_{i}'] = {
            'cross_attn': {
                'q_proj': {'kernel': in_proj_w[:dim].T, 'bias': in_proj_b[:dim]},
                'k_proj': {'kernel': in_proj_w[dim:2 * dim].T, 'bias': in_proj_b[dim:2 * dim]},
                'v_proj': {'kernel': in_proj_w[2 * dim:].T, 'bias': in_proj_b[2 * dim:]},
                'out_proj': _lin(sd, f'{lp}.cross_attn.out_proj'),
            },
            'self_attn': {
                'q_proj': _lin(sd, f'{lp}.self_attn.q_proj'),
                'k_proj': _lin(sd, f'{lp}.self_attn.k_proj'),
                'v_proj': _lin(sd, f'{lp}.self_attn.v_proj'),
                'out_proj': _lin(sd, f'{lp}.self_attn.out_proj'),
            },
            'cross_attn_layer_norm': _norm(sd, f'{lp}.cross_attn_layer_norm'),
            'self_attn_layer_norm': _norm(sd, f'{lp}.self_attn_layer_norm'),
            'final_layer_norm': _norm(sd, f'{lp}.final_layer_norm'),
            'fc1': _lin(sd, f'{lp}.fc1'),
            'fc2': _lin(sd, f'{lp}.fc2'),
        }
    return params


def convert_hf_state_dict(sd: Mapping, cfg: Mask2FormerConfig) -> dict[str, torch.Tensor]:
    """A ``Mask2FormerForUniversalSegmentation`` state dict (tensors or
    numpy arrays) → this package's ``state_dict``, through the flax tree."""
    sd = {k: _as_numpy(v) for k, v in sd.items()}
    tree = {
        'backbone': convert_swin_backbone(
            sd, cfg.backbone_config, prefix='model.pixel_level_module.encoder.'),
        'pixel_decoder': convert_pixel_decoder(sd, cfg, prefix='model.pixel_level_module.decoder.'),
        'transformer_module': convert_transformer_module(sd, cfg,
                                                         prefix='model.transformer_module.'),
        'class_predictor': _lin(sd, 'class_predictor'),
    }
    return params_from_jax(tree)


def _as_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


_SAFETENSORS_DTYPES = {
    'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16, 'BF16': torch.bfloat16,
    'I64': torch.int64, 'I32': torch.int32, 'I16': torch.int16, 'I8': torch.int8,
    'U8': torch.uint8, 'BOOL': torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file → {name: CPU tensor}: an 8-byte little-endian
    header length, a JSON header of {name: {dtype, shape, data_offsets}}
    (offsets from the end of the header), then the little-endian buffers."""
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], 'little')
    header = json.loads(data[8:8 + n])
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        dtype = _SAFETENSORS_DTYPES[info['dtype']]
        lo, hi = info['data_offsets']
        count = (hi - lo) // torch.empty((), dtype=dtype).element_size()
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=start + lo) if count else \
            torch.empty((0,), dtype=dtype)
        out[name] = flat.reshape(info['shape']).clone()
    return out


def load_hf_checkpoint(path: str) -> tuple[Mask2FormerConfig, dict[str, torch.Tensor]]:
    """(config, ``state_dict``) from an HF checkpoint directory
    (``model.safetensors`` or ``pytorch_model.bin``)."""
    cfg = Mask2FormerConfig.from_json(path)
    st_path = os.path.join(path, 'model.safetensors')
    if os.path.exists(st_path):
        sd = read_safetensors(st_path)
    else:
        sd = torch.load(os.path.join(path, 'pytorch_model.bin'), map_location='cpu',
                        weights_only=True)
    return cfg, convert_hf_state_dict(sd, cfg)
