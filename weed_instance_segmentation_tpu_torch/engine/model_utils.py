"""Model construction: architecture presets, seeded initialisation, and
loading a saved model.

Port of ``config_for_arch``, the from-scratch branch of ``build_model``,
``resolve_model_path`` and ``load_model`` in
``weed_instance_segmentation_tpu/engine/model_utils.py``. ``load_model``
returns the model and its config: the image processor (PIL) comes with the
raw-data slice, and plotting with the tail of the port.

Initialisation follows the flax initialisers of the JAX package, drawn from
one seeded ``torch.Generator`` (the numbers differ from ``jax.random``'s):
lecun-normal (truncated) Dense/Conv kernels with zero biases, xavier-uniform
attention, MSDA projection, mask-embedder and decoder-FFN kernels, zero
``sampling_offsets`` kernel with the radial-grid bias, zero
``attention_weights``, unit/zero norms, and normal(0.02) query and decoder
level embeddings.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2Former
from weed_instance_segmentation_tpu_torch.models.pixel_decoder import (
    MSDeformAttn, deform_offsets_bias_init,
)
from weed_instance_segmentation_tpu_torch.models.transformer_decoder import (
    DecoderLayer, MaskPredictor, MultiheadAttention, TransformerModule,
)


def config_for_arch(arch: str, **kwargs) -> Mask2FormerConfig:
    if arch == 'tiny-test':
        return Mask2FormerConfig.tiny_test(**kwargs)
    if arch.startswith('swin-'):
        return Mask2FormerConfig.swin(arch.split('-', 1)[1], **kwargs)
    raise ValueError(f'Unknown model arch {arch!r}')


def _lecun_normal_(weight: torch.Tensor, g: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal, variance 1/fan_in."""
    fan_in = weight[0].numel()  # Linear (out, in) and Conv (out, in, kh, kw)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=g)


@torch.no_grad()
def init_weights(model: Mask2Former, seed: int = 0) -> None:
    """Initialise every parameter of ``model`` in place from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    cfg = model.config
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(module.weight, g)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)

    xavier = []
    for module in model.modules():
        if isinstance(module, (MultiheadAttention, MaskPredictor)):
            xavier += [m for m in module.children() if isinstance(m, nn.Linear)]
        elif isinstance(module, DecoderLayer):
            xavier += [module.fc1, module.fc2]
        elif isinstance(module, MSDeformAttn):
            xavier += [module.value_proj, module.output_proj]
            nn.init.zeros_(module.sampling_offsets.weight)
            module.sampling_offsets.bias.copy_(torch.from_numpy(deform_offsets_bias_init(
                module.num_heads, module.n_levels, module.n_points)))
            nn.init.zeros_(module.attention_weights.weight)
            nn.init.zeros_(module.attention_weights.bias)
        elif isinstance(module, TransformerModule):
            for p in (module.level_embed, module.queries_embedder, module.queries_features):
                nn.init.normal_(p, std=cfg.init_std, generator=g)
    for linear in xavier:
        nn.init.xavier_uniform_(linear.weight, generator=g)

    for name, p in model.named_parameters():
        if name.endswith('relative_position_bias_table') or name == 'pixel_decoder.level_embed':
            nn.init.zeros_(p)


def _device(device: str | torch.device, caller: str) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{caller}: no CUDA device is available; pass device=\'cpu\' '
                           'to build the model on the CPU')
    return device


def build_model(arch: str, num_labels: int, dtype: torch.dtype = torch.float32,
                device: str | torch.device = 'cuda', seed: int = 0, *, train: bool = False,
                remat: bool | str = False) -> Mask2Former:
    """Randomly initialised ``Mask2Former`` for ``arch`` on ``device`` (the
    card unless the caller asks for the CPU; without a card, 'cuda' raises).

    Serving (``train=False``): eval mode, parameters of ``dtype``, and it
    computes in ``dtype``. Training (``train=True``): train mode with float32
    parameters, the AdamW master copy; the bf16 compute comes from the train
    step's autocast, as the JAX package's ``dtype=bf16, param_dtype=f32``
    pair. ``remat`` as :class:`Mask2Former` takes it."""
    device = _device(device, 'build_model')
    if train and dtype != torch.float32:
        raise ValueError(f'a training model keeps float32 parameters, got dtype={dtype}')
    cfg = config_for_arch(arch, num_labels=num_labels)
    with torch.device('meta'):
        model = Mask2Former(cfg, remat=remat)
    model.to_empty(device='cpu')
    init_weights(model, seed)
    return model.to(device=device, dtype=dtype).train(train)


def _compute_dtype() -> torch.dtype:
    """``config.COMPUTE_DTYPE`` ('float32', 'bfloat16', …) as a torch dtype."""
    return getattr(torch, config.COMPUTE_DTYPE)


def resolve_model_path(model_id: str) -> str:
    """``MODELS_OUTPUT_DIR/<model_id>``, with any ``latest`` path component
    replaced by the name-wise newest existing subdirectory (run directories
    are ``YYYY-MM-DD_HH-MM-SS``, so name order is time order); a ``latest``
    directory that exists is kept."""
    path = os.path.join(config.MODELS_OUTPUT_DIR, model_id)
    parts = path.split(os.sep)
    for i, part in enumerate(parts):
        if part != 'latest' or os.path.isdir(os.sep.join(parts[: i + 1])):
            continue
        parent = os.sep.join(parts[:i]) or os.sep
        runs = sorted(d for d in (os.listdir(parent) if os.path.isdir(parent) else [])
                      if os.path.isdir(os.path.join(parent, d)))
        if runs:
            parts[i] = runs[-1]
    return os.sep.join(parts)


def model_from_state_dict(cfg: Mask2FormerConfig, state_dict: dict,
                          dtype: torch.dtype = torch.float32,
                          device: str | torch.device = 'cuda') -> Mask2Former:
    """An eval-mode ``Mask2Former`` of ``cfg`` holding ``state_dict`` (every
    key filled, none left over), on ``device`` in ``dtype``."""
    device = _device(device, 'model_from_state_dict')
    with torch.device('meta'):
        model = Mask2Former(cfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.to(device=device, dtype=dtype).eval()


def load_model(model_id: str, device: str | torch.device = 'cuda'
               ) -> tuple[Mask2Former, Mask2FormerConfig]:
    """(model, config) from ``MODELS_OUTPUT_DIR/<model_id>`` (a ``latest``
    component resolves as :func:`resolve_model_path` says). The float32
    parameters are loaded, then the model is cast to
    ``config.COMPUTE_DTYPE``, in which it computes, as the serving model
    does; it is built on ``device``, the card unless the caller asks for
    the CPU."""
    cfg, state_dict = ckpt.load_pretrained(resolve_model_path(model_id))
    return model_from_state_dict(cfg, state_dict, _compute_dtype(), device), cfg
