"""The masked-attention decoder's attention mask: CUDA kernel and plain
version.

Each layer's mask prediction becomes the next layer's attention mask
(``models/transformer_decoder.py::MaskPredictor``, HF:2008-2023): the
(B, Q, H, W) mask logits are resized bilinearly to the next level's (h, w)
(``align_corners=False``), a position is blocked where the sigmoid of the
resized logit is under 0.5 (HF:2021), and a row with every position blocked
attends everywhere (HF:1880-1882). The result is the (B, 1, Q, h·w) bool
mask that ``ops/masked_attention.py`` takes, True = blocked, shared over
heads.

:func:`attention_mask` calls the registered operator
``torch.ops.wistpu.attention_mask``, so that ``torch.export`` records it
(``engine/export.py``): for a CPU tensor it is :func:`attention_mask_plain`
(``F.interpolate``, ``sigmoid``, ``< 0.5``, the row ``all`` and ``& ~``);
for a CUDA tensor it launches ``csrc/attention_mask.cu``, one launch that
gives the plain version's bits in float32 and bfloat16 (see the note there on
what bounds it), or raises. There is no fallback. Under CUDA autocast,
:func:`attention_mask` hands the operator float32 logits where the size
changes, as autocast hands ``F.interpolate`` (on its float32 list) the plain
version's, so that training's masks are the plain version's there too. Each launch adds one to the
counter :data:`LAUNCHES` (``engine/trace.py``). The mask takes no gradient.
The JAX package resizes and thresholds with XLA, so the kernel replaces no
Pallas kernel.
"""

from __future__ import annotations

import torch

from weed_instance_segmentation_tpu_torch.ops.cuda_build import count_launch, entry_point, launch
from weed_instance_segmentation_tpu_torch.ops.resize import interpolate_bilinear

_LIBRARY = 'attention_mask'
LAUNCHES = 'wistpu.attention_mask.launches'


def attention_mask_plain(mask_logits: torch.Tensor, size) -> torch.Tensor:
    """(B, Q, H, W) mask logits → bool (B, 1, Q, h·w), True = blocked."""
    attn = interpolate_bilinear(mask_logits, tuple(size))
    masked = torch.sigmoid(attn).flatten(2) < 0.5  # True = blocked (HF:2021)
    # all-masked-row escape: a row with every position masked attends
    # everywhere (HF:1880-1882)
    masked = masked & ~masked.all(dim=-1, keepdim=True)
    return masked[:, None]  # broadcast over heads


def _check_kernel(mask_logits: torch.Tensor, size) -> None:
    """What the kernel takes: float32 or bfloat16 (B, Q, H, W) contiguous
    logits and a positive (h, w). The entry point refuses a row too long for
    a block's shared memory, which :func:`launch` raises."""
    if mask_logits.ndim != 4 or len(size) != 2 or min(size) < 1:
        raise ValueError(f'mask logits must be (B, Q, H, W) and the size (h, w) positive, got '
                         f'{tuple(mask_logits.shape)} and {tuple(size)}')
    if mask_logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernel takes float32 or bfloat16 logits, got {mask_logits.dtype}')
    if not mask_logits.is_contiguous():
        raise ValueError('the kernel\'s logits must be contiguous')


@torch.library.custom_op('wistpu::attention_mask', mutates_args=(), device_types='cpu',
                         schema='(Tensor mask_logits, int[] size) -> Tensor')
def _op(mask_logits, size):
    return attention_mask_plain(mask_logits, size)


@_op.register_kernel('cuda')
def _cuda(mask_logits, size):
    _check_kernel(mask_logits, size)
    b, q, h_in, w_in = mask_logits.shape
    h, w = size
    out = torch.empty((b, 1, q, h * w), dtype=torch.bool, device=mask_logits.device)
    launch(entry_point(_LIBRARY, 'wis_attention_mask', 2, 6), mask_logits.device,
           f'attention mask for logits {tuple(mask_logits.shape)} to {(h, w)}',
           mask_logits.data_ptr(), out.data_ptr(), b * q, h_in, w_in, h, w,
           int(mask_logits.dtype == torch.bfloat16))
    count_launch(LAUNCHES)
    return out


@_op.register_fake
def _fake(mask_logits, size):
    b, q = mask_logits.shape[:2]
    return mask_logits.new_empty((b, 1, q, size[0] * size[1]), dtype=torch.bool)


def attention_mask(mask_logits: torch.Tensor, size) -> torch.Tensor:
    """(B, Q, H, W) mask logits → the next layer's attention mask, bool
    (B, 1, Q, h·w) for ``size`` (h, w), True = blocked: the operator
    ``torch.ops.wistpu.attention_mask`` (the kernel on a CUDA tensor, which
    raises on what it does not take; :func:`attention_mask_plain` on a CPU
    tensor). It has no gradient: pass detached logits."""
    if (mask_logits.is_cuda and torch.is_autocast_enabled('cuda')
            and tuple(mask_logits.shape[-2:]) != tuple(size)):
        # autocast resizes in float32 (upsample_bilinear2d is on its float32
        # list); where the size is kept, the plain version thresholds the
        # logits in their own type
        mask_logits = mask_logits.float()
    return _op(mask_logits, list(size))
