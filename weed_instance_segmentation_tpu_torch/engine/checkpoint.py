"""Model checkpoints in the JAX package's format.

Port of ``save_pretrained``/``load_pretrained`` in
``weed_instance_segmentation_tpu/engine/checkpoint.py``: a directory holding
``config.json`` (the HF layout, ``Mask2FormerConfig.save_json``) and
``params.npz``, the flax parameter tree flattened with its keys joined by
``/`` (``backbone/stage0_block0/attention/query/kernel``), float32. The tree
comes from ``models/convert.py::state_dict_to_jax`` and goes back through
``params_from_jax``, so a directory either package writes loads in the
other. A directory without ``params.npz`` is read as an HF checkpoint
(``models/convert.py::load_hf_checkpoint``), as the JAX package does.

The train-state checkpoint (optimizer state and step, for resuming) and the
image processor's ``preprocessor_config.json`` come with the training and
raw-data slices.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.convert import (
    load_hf_checkpoint, params_from_jax, state_dict_to_jax,
)

PARAMS_FILE = 'params.npz'


def _flatten(tree: Mapping, prefix: str = '') -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, f'{prefix}{key}/'))
        else:
            flat[prefix + key] = np.asarray(value)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *path, name = key.split('/')
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = value
    return tree


def save_pretrained(directory: str, state_dict: Mapping[str, torch.Tensor],
                    cfg: Mask2FormerConfig) -> None:
    """``config.json`` + ``params.npz`` of ``state_dict`` (a model's, on any
    device and in any dtype; written as float32)."""
    os.makedirs(directory, exist_ok=True)
    cfg.save_json(directory)
    with open(os.path.join(directory, PARAMS_FILE), 'wb') as f:
        np.savez(f, **_flatten(state_dict_to_jax(state_dict)))


def load_pretrained(directory: str) -> tuple[Mask2FormerConfig, dict[str, torch.Tensor]]:
    """(config, CPU ``state_dict``) from a directory written by either
    package's ``save_pretrained``, or from an HF checkpoint directory."""
    params_path = os.path.join(directory, PARAMS_FILE)
    if not os.path.exists(params_path):
        return load_hf_checkpoint(directory)
    cfg = Mask2FormerConfig.from_json(directory)
    with np.load(params_path, allow_pickle=False) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return cfg, params_from_jax(tree)
