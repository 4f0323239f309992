"""Model construction: architecture presets and seeded initialisation.

Port of ``config_for_arch`` and the from-scratch branch of ``build_model`` in
``weed_instance_segmentation_tpu/engine/model_utils.py``. Checkpoint loading,
the image processor and plotting wait for the entry-point slice.

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

import torch
from torch import nn

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
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('build_model: no CUDA device is available; pass device=\'cpu\' '
                           'to build the model on the CPU')
    if train and dtype != torch.float32:
        raise ValueError(f'a training model keeps float32 parameters, got dtype={dtype}')
    cfg = config_for_arch(arch, num_labels=num_labels)
    with torch.device('meta'):
        model = Mask2Former(cfg, remat=remat)
    model.to_empty(device='cpu')
    init_weights(model, seed)
    return model.to(device=device, dtype=dtype).train(train)
