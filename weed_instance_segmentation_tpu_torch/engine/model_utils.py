"""Model construction: architecture presets, seeded initialisation, and
loading a saved model.

Port of ``config_for_arch``, ``build_model``, ``resolve_model_path``,
``load_model``, ``default_processor`` and ``plot_segmentation`` in
``weed_instance_segmentation_tpu/engine/model_utils.py``. The JAX
``build_model`` is :func:`build_model_for_labels` here (a local checkpoint
directory, else ``config.MODEL_ARCH`` from scratch); :func:`build_model`
builds an architecture from scratch. ``load_model`` returns the model and
its config. :func:`plot_segmentation` imports matplotlib when called, so the
module imports without it.

Initialisation follows the flax initialisers of the JAX package, drawn from
one seeded ``torch.Generator`` (the numbers differ from ``jax.random``'s):
lecun-normal (truncated) Dense/Conv kernels with zero biases, xavier-uniform
attention, MSDA projection, mask-embedder and decoder-FFN kernels, zero
``sampling_offsets`` kernel with the radial-grid bias, zero
``attention_weights``, unit/zero norms (a frozen batch norm's scale and
variance one, its bias and mean zero), and normal(0.02) query and decoder
level embeddings.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2Former
from weed_instance_segmentation_tpu_torch.models.pixel_decoder import (
    MSDeformAttn, deform_offsets_bias_init,
)
from weed_instance_segmentation_tpu_torch.models.resnet import FrozenBatchNorm
from weed_instance_segmentation_tpu_torch.models.transformer_decoder import (
    DecoderLayer, MaskPredictor, MultiheadAttention, TransformerModule,
)
from weed_instance_segmentation_tpu_torch.processing.image_processor import (
    Mask2FormerImageProcessor,
)


def config_for_arch(arch: str, **kwargs) -> Mask2FormerConfig:
    """The config of ``arch`` ('tiny-test', 'resnet50', 'swin-<variant>').
    ``WISTPU_ENCODER_POINTS``, where set, gives the deformable encoder's
    sampling points per level (the HF reference's 4 otherwise); a model of
    other than 4 cannot load a 4-point checkpoint."""
    if arch == 'tiny-test':
        cfg = Mask2FormerConfig.tiny_test(**kwargs)
    elif arch == 'resnet50':
        cfg = Mask2FormerConfig.resnet50(**kwargs)
    elif arch.startswith('swin-'):
        cfg = Mask2FormerConfig.swin(arch.split('-', 1)[1], **kwargs)
    else:
        raise ValueError(f'Unknown model arch {arch!r}')
    points = os.environ.get('WISTPU_ENCODER_POINTS')
    if points:
        cfg.encoder_n_points = int(points)
    return cfg


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
        elif isinstance(module, FrozenBatchNorm):
            for p, fill in ((module.scale, 1.0), (module.bias, 0.0), (module.mean, 0.0),
                            (module.var, 1.0)):
                nn.init.constant_(p, fill)

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


def require_device(device: str | torch.device, caller: str) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{caller}: no CUDA device is available; pass device=\'cpu\' '
                           'to run on the CPU')
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
    device = require_device(device, 'build_model')
    if train and dtype != torch.float32:
        raise ValueError(f'a training model keeps float32 parameters, got dtype={dtype}')
    cfg = config_for_arch(arch, num_labels=num_labels)
    with torch.device('meta'):
        model = Mask2Former(cfg, remat=remat)
    model.to_empty(device='cpu')
    init_weights(model, seed)
    return model.to(device=device, dtype=dtype).train(train)


def _set_labels(cfg: Mask2FormerConfig, id2label: dict, label2id: dict | None) -> None:
    cfg.id2label = id2label
    cfg.label2id = label2id or {v: k for k, v in id2label.items()}
    cfg.num_labels = len(id2label)


def build_model_for_labels(id2label: dict, label2id: dict | None = None,
                           checkpoint: str | None = None, seed: int = 0,
                           device: str | torch.device = 'cuda'
                           ) -> tuple[Mask2Former, Mask2FormerConfig]:
    """A training model (train mode, float32 parameters, ``config.REMAT``)
    for the labels ``id2label``, on ``device``, and its config.

    Where ``checkpoint`` (default ``config.MODEL_CHECKPOINT``) is a local
    directory, its weights are loaded and its labels replaced by these; when
    the label count differs, the class head is initialised anew from
    ``seed`` (the HF ``ignore_mismatched_sizes``). Otherwise
    ``config.MODEL_ARCH`` is initialised from ``seed``: nothing is
    downloaded."""
    device = require_device(device, 'build_model_for_labels')
    checkpoint = checkpoint if checkpoint is not None else config.MODEL_CHECKPOINT
    if not os.path.isdir(checkpoint):
        print(f'Checkpoint {checkpoint!r} is not a local directory — initializing '
              f'{config.MODEL_ARCH} from scratch.')
        model = build_model(config.MODEL_ARCH, len(id2label), device=device, seed=seed,
                            train=True, remat=config.REMAT)
        _set_labels(model.config, id2label, label2id)
        return model, model.config

    cfg, state_dict = ckpt.load_pretrained(checkpoint)
    mismatched = len(id2label) != cfg.num_labels
    if mismatched:
        print(f'Reinitializing class head: checkpoint has {cfg.num_labels} labels, '
              f'requested {len(id2label)} (ignore_mismatched_sizes).')
    _set_labels(cfg, id2label, label2id)
    with torch.device('meta'):
        model = Mask2Former(cfg, remat=config.REMAT)
    if mismatched:
        model.to_empty(device='cpu')
        init_weights(model, seed)
        state_dict = {k: v for k, v in state_dict.items() if not k.startswith('class_predictor.')}
        missing, unexpected = model.load_state_dict(state_dict, strict=False)
        if unexpected or any(not k.startswith('class_predictor.') for k in missing):
            raise ValueError(f'checkpoint {checkpoint!r} does not fit its config: '
                             f'missing {missing}, unexpected {unexpected}')
    else:
        model.load_state_dict(state_dict, strict=True, assign=True)
    return model.to(device=device, dtype=torch.float32).train(), cfg


def default_processor(checkpoint: str | None = None) -> Mask2FormerImageProcessor:
    """The processor of ``checkpoint`` (default ``config.MODEL_CHECKPOINT``)
    where it is a directory holding one, else the HF Mask2Former defaults
    with ``config.SHORTEST_EDGE``/``LONGEST_EDGE``."""
    checkpoint = checkpoint if checkpoint is not None else config.MODEL_CHECKPOINT
    if os.path.exists(os.path.join(checkpoint, 'preprocessor_config.json')):
        return Mask2FormerImageProcessor.from_pretrained(checkpoint)
    return Mask2FormerImageProcessor(
        size={'shortest_edge': config.SHORTEST_EDGE, 'longest_edge': config.LONGEST_EDGE},
        ignore_index=None,  # the readers pass ignore_index=255 per call
    )


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
    device = require_device(device, 'model_from_state_dict')
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


def plot_segmentation(
    image,
    result: dict,
    id2label: dict | None = None,
    score_threshold: float = 0.5,
    color_by_class: bool = False,
    ax=None,
    title: str = 'Instance Segmentation',
    show: bool = True,
):
    """Draw ``result``'s instances over ``image``: a translucent fill and a
    contour each, and a legend of label and score (tab20 colours for up to
    20 instances, else nipy_spectral). Segments scoring below
    ``score_threshold`` are left out. Draws into ``ax``, or a new figure."""
    import matplotlib

    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib import patches as mpatches

    segmentation = np.asarray(result['segmentation'])
    segments_info = [
        s for s in result['segments_info'] if s.get('score', 1.0) >= score_threshold
    ]

    own_fig = ax is None
    if own_fig:
        _, ax = plt.subplots(figsize=(10, 8))
    ax.imshow(np.asarray(image))
    ax.set_title(title)
    ax.axis('off')

    n = len(segments_info)
    if n <= 20:
        cmap = matplotlib.colormaps['tab20']
        colors = [cmap(i % 20) for i in range(max(n, 1))]
    else:
        cmap = matplotlib.colormaps['nipy_spectral']
        colors = [cmap(i / max(n - 1, 1)) for i in range(n)]

    legend_handles = []
    class_color: dict[int, tuple] = {}
    for i, info in enumerate(segments_info):
        mask = segmentation == info['id']
        if color_by_class:
            color = class_color.setdefault(info['label_id'], colors[len(class_color) % len(colors)])
        else:
            color = colors[i]
        overlay = np.zeros((*mask.shape, 4))
        overlay[mask] = (*color[:3], 0.45)
        ax.imshow(overlay)
        ax.contour(mask, levels=[0.5], colors=[color], linewidths=1.5)
        label = (
            id2label.get(info['label_id'], str(info['label_id']))
            if id2label else str(info['label_id'])
        )
        legend_handles.append(
            mpatches.Patch(color=color, label=f"{label} ({info.get('score', 0):.2f})")
        )
    if legend_handles:
        ax.legend(handles=legend_handles, loc='upper right', fontsize=8)
    if own_fig and show:
        plt.show()
    return ax
