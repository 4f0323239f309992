"""Instance-segmentation post-processing on the device.

Port of ``weed_instance_segmentation_tpu/processing/postprocess.py::
post_process_instance_arrays``, which replicates HF
``post_process_instance_segmentation`` (image_processing_mask2former.py:
1069-1188):

- mask logits are bilinearly upsampled to a hard-coded (384, 384) before
  scoring (HF:1122-1124);
- scores = softmax(class logits)[:, :-1], flattened (Q·C) top-k with
  k = num_queries (HF:1138-1141);
- binary masks = logits > 0 at 384²; mask score = mean sigmoid inside the
  binary mask with +1e-6 (HF:1148-1151); final score = class·mask score;
- binary masks nearest-resized (torch legacy floor) to the target size;
- sequential overwrite into an int id map, -1 background, ids 0,1,2,… in
  top-k order over kept queries; empty masks are skipped.

The upsample and its per-query statistics come from
``ops.postprocess_kernel.fused_upsample_stats``: the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor. The rest is batched tensor code
with fixed-size outputs: the per-query overwrite loop becomes a max over
"last kept slot covering this pixel", evaluated at 384² so that only the
final int32 id map is gathered to the target size.

Top-k order: ``lax.top_k`` in the JAX package returns values sorted
descending, the lower index first on ties; a stable descending sort gives
the same order (``torch.topk`` on CUDA promises no tie order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.ops.constants import device_constant
from weed_instance_segmentation_tpu_torch.ops.postprocess_kernel import fused_upsample_stats
from weed_instance_segmentation_tpu_torch.ops.resize import nearest_indices

SCORE_RESOLUTION = (384, 384)  # HF:1122 — hard-coded for all models


class InstanceSegmentationResult(NamedTuple):
    """Fixed-size result arrays, batch-leading: ``segmentation`` (B, H, W)
    int32 id map with -1 background; per-slot arrays aligned with top-k
    order."""

    segmentation: torch.Tensor  # (B, H, W) int32, -1 = background
    segment_ids: torch.Tensor  # (B, Q) int32, -1 for dropped slots
    labels: torch.Tensor  # (B, Q) int32 class label per slot
    scores: torch.Tensor  # (B, Q) float32 final score per slot
    valid: torch.Tensor  # (B, Q) bool — slot kept
    masks: Optional[torch.Tensor]  # (B, Q, H, W) bool at target size, or None


def _sampled_rows(in_size: int, out_size: int) -> np.ndarray:
    """Source indices the target grid's nearest resize reads, deduplicated."""
    return np.unique(nearest_indices(in_size, out_size))


def post_process_instance_arrays(
    class_queries_logits: torch.Tensor,
    masks_queries_logits: torch.Tensor,
    target_size: tuple[int, int],
    threshold: float = 0.5,
    with_masks: bool = True,
) -> InstanceSegmentationResult:
    """Inputs (B, Q, C+1) and (B, Q, Hm, Wm) float32; returns fixed-size
    batch-leading arrays. ``with_masks=False`` (the serving path) skips the
    (B, Q, H, W) target-size masks."""
    th, tw = target_size
    sh, sw = SCORE_RESOLUTION
    dev = class_queries_logits.device
    sig_sum, pos_cnt, bin_i8 = fused_upsample_stats(
        masks_queries_logits.float().contiguous(), SCORE_RESOLUTION)
    bins = bin_i8 != 0  # (B, Q, 384, 384), original query order

    ys = device_constant(nearest_indices, (sh, th), dev)
    xs = device_constant(nearest_indices, (sw, tw), dev)
    mask_scores_q = sig_sum / (pos_cnt + 1e-6)  # (B, Q)
    hit_rows = _sampled_rows(sh, th)
    hit_cols = _sampled_rows(sw, tw)
    if len(hit_rows) == sh and len(hit_cols) == sw:
        # the target grid samples every 384² pixel: coverage is pos_cnt > 0
        covers_q = pos_cnt > 0
    else:
        rows = device_constant(_sampled_rows, (sh, th), dev)
        cols = device_constant(_sampled_rows, (sw, tw), dev)
        covers_q = bins[:, :, rows][:, :, :, cols].flatten(2).any(dim=-1)

    b, num_queries, num_classes_p1 = class_queries_logits.shape
    if num_queries >= 2 ** 15 - 1:
        raise ValueError(f'{num_queries} queries overflow the int16 slot map')
    num_classes = num_classes_p1 - 1
    scores = torch.softmax(class_queries_logits.float(), dim=-1)[..., :-1]
    flat = scores.reshape(b, -1)
    sorted_scores, order = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_scores, top_idx = sorted_scores[:, :num_queries], order[:, :num_queries]
    labels = top_idx % num_classes
    query_idx = top_idx // num_classes  # (B, Q slots)
    pred_scores = top_scores * torch.gather(mask_scores_q, 1, query_idx)

    keep = (pred_scores >= threshold) & torch.gather(covers_q, 1, query_idx)
    # ids 0,1,2,… assigned in slot order over kept slots (HF:1171)
    seg_ids = torch.where(keep, torch.cumsum(keep, dim=1) - 1, -1).to(torch.int32)

    # per original query, the last kept slot that selects it (-1 if none):
    # a query can pass top-k under several classes
    slots = torch.arange(num_queries, device=dev)
    selects = (query_idx[:, None, :] == slots[None, :, None]) & keep[:, None, :]
    maxslot_q = torch.where(selects, slots, -1).amax(dim=-1)  # (B, Q)
    # per pixel, the last kept slot whose mask covers it (the sequential
    # overwrite), as a max over queries; int16 holds slot + 1 for Q < 32767
    slot_code = (maxslot_q + 1).to(torch.int16)[:, :, None, None]
    last_slot = (bins.to(torch.int16) * slot_code).amax(dim=1).long() - 1  # (B, 384, 384)
    seg_small = torch.where(
        last_slot >= 0,
        torch.gather(seg_ids, 1, last_slot.clamp(min=0).flatten(1)).reshape(last_slot.shape),
        -1,
    )
    segmentation = seg_small[:, ys][:, :, xs].to(torch.int32)

    masks = None
    if with_masks:
        batch = torch.arange(b, device=dev)[:, None]
        masks = bins[batch, query_idx][:, :, ys][:, :, :, xs]
    return InstanceSegmentationResult(
        segmentation=segmentation,
        segment_ids=seg_ids,
        labels=labels.to(torch.int32),
        scores=pred_scores.float(),
        valid=keep,
        masks=masks,
    )
