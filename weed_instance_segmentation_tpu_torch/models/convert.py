"""JAX package flax params → this package's ``state_dict``.

The port's module attributes follow the flax tree's names
(``backbone.stage0_block1.attention.query``,
``pixel_decoder.encoder_layer_3.self_attn.sampling_offsets``,
``transformer_module.layer_8.cross_attn.q_proj``, …), so the conversion is a
flatten plus three layout rules:

- Dense ``kernel`` (in, out) → Linear ``weight`` (out, in);
- Conv ``kernel`` HWIO → Conv2d ``weight`` OIHW;
- LayerNorm/GroupNorm ``scale`` → ``weight``.

Every other leaf (biases, ``relative_position_bias_table``, ``level_embed``,
the query embeddings) keeps its name and layout. Load the result with
``model.load_state_dict(sd, strict=True)``, which raises on any key left
unfilled or unused.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == 'kernel':
        if value.ndim == 2:
            return 'weight', value.T
        if value.ndim == 4:
            return 'weight', value.transpose(3, 2, 0, 1)
        raise ValueError(f'kernel of rank {value.ndim} has no torch layout rule')
    if name == 'scale':
        return 'weight', value
    return name, value


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested flax param tree (numpy or array-like leaves) → flat state_dict.

    Every leaf becomes exactly one entry; a leaf with no layout rule raises.
    """
    state_dict: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f'{prefix}{key}.')
                continue
            name, array = _leaf(key, np.asarray(value))
            full = prefix + name
            if full in state_dict:
                raise ValueError(f'two flax leaves map to {full!r}')
            state_dict[full] = torch.from_numpy(np.ascontiguousarray(array).copy())

    walk(params, '')
    return state_dict
