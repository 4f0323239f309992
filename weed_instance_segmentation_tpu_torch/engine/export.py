"""Serving function: uint8 images in, instance arrays out.

Port of ``make_serving_fn`` in ``weed_instance_segmentation_tpu/engine/export.py``:

    uint8 image batch (B, H_in, W_in, 3) on the model's device
      → fused pre-process (processing/fused.py)
      → Mask2Former forward
      → instance post-process (processing/postprocess.py), in float32
      → fixed-shape result arrays (segmentation map, labels, scores, …)

The portable serialized artifact of the JAX package (``jax.export``) and its
CLI are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from weed_instance_segmentation_tpu_torch.processing.fused import fused_preprocess
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    post_process_instance_arrays,
)


def make_serving_fn(model: torch.nn.Module, *, out_hw: tuple[int, int],
                    target_size: tuple[int, int] | None = None,
                    threshold: float = 0.5,
                    micro_batch: int = 0,
                    emit_masks: bool = True) -> Callable[[torch.Tensor], dict]:
    """(raw uint8 (B, H_in, W_in, 3)) → dict of InstanceSegmentationResult
    arrays, batch-leading.

    ``out_hw`` is the model input resolution after the pre-process;
    ``target_size`` the resolution of the returned segmentation maps
    (defaults to ``out_hw``). ``micro_batch`` > 0 runs the request in
    sub-batches of that size, one after another, which caps activation
    memory at the sub-batch; the request batch must divide evenly.
    ``emit_masks=False`` drops the (B, Q, H, W) per-instance masks: the int32
    id map and the per-slot arrays describe the non-overlapping output.
    """
    tgt = tuple(target_size or out_hw)
    device = next(model.parameters()).device

    def one(raw: torch.Tensor) -> dict:
        pixel_values, _ = fused_preprocess(raw, out_hw, out_hw)
        out = model(pixel_values)
        res = post_process_instance_arrays(
            out.class_queries_logits.float(), out.masks_queries_logits.float(),
            tgt, threshold, with_masks=emit_masks,
        )._asdict()
        if not emit_masks:
            res.pop('masks')
        return res

    @torch.inference_mode()
    def serve(raw: torch.Tensor) -> dict:
        if raw.device != device:
            raise ValueError(f'images are on {raw.device}, the model on {device}')
        b = raw.shape[0]
        if not micro_batch or b <= micro_batch:
            return one(raw)
        if b % micro_batch:
            raise ValueError(f'serving batch {b} not divisible by micro_batch {micro_batch}')
        parts = [one(chunk) for chunk in raw.split(micro_batch)]
        return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}

    return serve
