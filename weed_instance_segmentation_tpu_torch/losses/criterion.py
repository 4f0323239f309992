"""Mask2Former training criterion.

Port of ``weed_instance_segmentation_tpu/losses/criterion.py``, with the
semantics of the HF loss (``transformers==4.57.6`` modeling_mask2former.py:
246-797, 2240-2295):

- Hungarian matcher over ``mask_weight``·pairwise sigmoid-CE +
  ``class_weight``·(−prob[target]) + ``dice_weight``·pairwise dice on
  ``train_num_points`` uniform points per image, cost clipped to ±1e10 with
  NaN → 0 (HF:414-484); padded target slots get a constant cost row, so they
  never move the assignment of the real ones.
- loss_cross_entropy: CE over queries with no-object weight 0.1, as
  Σ w·nll / Σ w (HF:547-580).
- loss_mask / loss_dice: sigmoid-CE and dice on points chosen by
  uncertainty: oversample 3×, keep the 75 % with the smallest |logit| (a
  stable ascending sort, the lower index first on ties), redraw the other
  25 % uniformly (HF:581-719), normalised by ``num_masks``.
- Aux layers carry the ``_{i}`` suffix; weights apply by substring; the total
  is the sum of the dict (HF:2275-2283).

Targets are padded to a static count with a validity mask (``pad_targets``).
The assignment runs on the host (``ops/lap.py``): every (layer, image)
problem of a step after one device→host copy of the stacked costs. The
criterion runs in float32 on the model's outputs, outside autocast.

Every random draw goes through one :class:`PointDraws` object, so a test can
replay another stack's draws.

Under data parallelism each rank computes the loss of its own rows. Two
hooks, ``num_masks_reduce`` and ``class_weight_reduce``, replace the
normalisers ``max(num_masks, 1)`` and ``max(Σw, 1e-8)`` with their global
values divided by the rank count (``parallel/mesh.py::loss_reducers``), so
that the ranks' mean loss, and the mean gradient DDP takes, are the
global batch's, as in the JAX program that GSPMD partitions.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from weed_instance_segmentation_tpu_torch.ops.grid_sample import sample_points
from weed_instance_segmentation_tpu_torch.ops.lap import batched_linear_sum_assignment
from weed_instance_segmentation_tpu_torch.parallel.mesh import rand_rows

Reduce = Callable[[torch.Tensor], torch.Tensor]


class PointDraws:
    """The random draws of one training step.

    ``uniform(kind, layer, shape, device)`` returns uniform [0, 1) float32
    numbers on ``device`` for draw ``kind`` of loss layer ``layer`` (0 = the
    final layer, i + 1 = aux layer i):

    - ``'matcher'``    (B, P, 2): the matcher's points per image;
    - ``'oversample'`` (n, int(3P), 2): the uncertainty candidates per
      matched pair;
    - ``'redraw'``     (n, P − int(0.75 P), 2): the uniform remainder.

    The default draws them in call order from ``generator`` (on the
    generator's device). ``generator`` also draws the augmentation's
    factors and the backbone's drop-path masks, in that order, before
    these. With ``shard`` = (index, count), a data rank's, each draw is
    part ``index`` of one ``count`` times as large over the leading axis
    (``parallel/mesh.py::rand_rows``): the rank's rows of what one process
    draws for the global batch. A test overrides ``uniform`` to replay the
    JAX package's draws.
    """

    def __init__(self, generator: torch.Generator | None = None,
                 shard: tuple[int, int] | None = None):
        self.generator = generator
        self.shard = shard

    def uniform(self, kind: str, layer: int, shape: tuple, device: torch.device) -> torch.Tensor:
        return rand_rows(shape, self.generator, device, self.shard)


def pad_targets(mask_labels: list, class_labels: list, max_instances: int,
                mask_hw: tuple[int, int] | None = None):
    """Host-side: ragged per-image target lists → static padded numpy arrays
    (target_masks (B, I, H, W) f32, target_classes (B, I) int32,
    target_valid (B, I) bool). ``mask_hw`` defaults to the batch max; images
    with more than ``max_instances`` targets are truncated."""
    b = len(mask_labels)
    if mask_hw is None:
        hs = [m.shape[1] if m.ndim == 3 and m.shape[0] else m.shape[-2] for m in mask_labels]
        ws = [m.shape[2] if m.ndim == 3 and m.shape[0] else m.shape[-1] for m in mask_labels]
        mask_hw = (max(hs, default=1), max(ws, default=1))
    h, w = mask_hw
    tm = np.zeros((b, max_instances, h, w), np.float32)
    tc = np.zeros((b, max_instances), np.int32)
    tv = np.zeros((b, max_instances), bool)
    for i, (m, c) in enumerate(zip(mask_labels, class_labels)):
        m = np.asarray(m, np.float32)
        c = np.asarray(c).reshape(-1)
        n = min(len(c), max_instances)
        if n:
            tm[i, :n, : m.shape[-2], : m.shape[-1]] = m[:n]
            tc[i, :n] = c[:n]
            tv[i, :n] = True
    return tm, tc, tv


def _sample_points_batch(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (N, H, W), coords (N, P, 2) in [0, 1] (x, y) → (N, P)."""
    return sample_points(masks[:, None], coords)[:, 0]


def _pairwise_sigmoid_ce(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """(…, Q, P), (…, N, P) → (…, Q, N) mean-over-points BCE cost (HF:355-380)."""
    p = pred_pts.shape[-1]
    pos = F.softplus(-pred_pts)  # BCE(logit, 1)
    neg = F.softplus(pred_pts)  # BCE(logit, 0)
    return (pos / p) @ tgt_pts.transpose(-1, -2) + (neg / p) @ (1.0 - tgt_pts).transpose(-1, -2)


def _pairwise_dice(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """(…, Q, P), (…, N, P) → (…, Q, N) dice cost (HF:331-352)."""
    probs = torch.sigmoid(pred_pts)
    numerator = 2.0 * (probs @ tgt_pts.transpose(-1, -2))
    denominator = probs.sum(-1)[..., :, None] + tgt_pts.sum(-1)[..., None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


@torch.no_grad()
def matcher_cost(masks_queries_logits: torch.Tensor, class_queries_logits: torch.Tensor,
                 target_masks: torch.Tensor, target_classes: torch.Tensor,
                 target_valid: torch.Tensor, point_coords: torch.Tensor,
                 class_weight: float, mask_weight: float, dice_weight: float) -> torch.Tensor:
    """Batched matcher cost (HF:379-477) on ``point_coords`` (B, P, 2) →
    (B, N_max, Q), the transposed LAP input. Padded target slots get a
    constant (zero) row."""
    b, q = class_queries_logits.shape[:2]
    n = target_classes.shape[1]
    pred_probs = torch.softmax(class_queries_logits, dim=-1)  # (B, Q, L+1)
    cost_class = -torch.gather(pred_probs, 2, target_classes.long()[:, None, :].expand(b, q, n))
    pred_pts = sample_points(masks_queries_logits, point_coords)  # (B, Q, P)
    tgt_pts = sample_points(target_masks, point_coords)  # (B, N, P)
    cost = (mask_weight * _pairwise_sigmoid_ce(pred_pts, tgt_pts)
            + class_weight * cost_class
            + dice_weight * _pairwise_dice(pred_pts, tgt_pts))
    cost = torch.nan_to_num(torch.clamp(cost, -1e10, 1e10), nan=0.0)
    cost = torch.where(target_valid[:, None, :], cost, 0.0)
    return cost.transpose(1, 2)


def hungarian_match(cost: torch.Tensor) -> torch.Tensor:
    """The host LAP on :func:`matcher_cost` output (..., N_max, Q), every
    problem of the leading dims after one device→host copy → assigned query
    (..., N_max) int64 for each (possibly padded) target slot."""
    return batched_linear_sum_assignment(cost.flatten(0, -3)).reshape(cost.shape[:-1])


@torch.no_grad()
def _uncertainty_points(pred_masks: torch.Tensor, draws: PointDraws, layer: int,
                        num_points: int, oversample_ratio: float,
                        importance_sample_ratio: float) -> torch.Tensor:
    """Uncertainty-based point coords per mask (HF:675-719): pred_masks
    (N, H, W) → (N, num_points, 2). The kept candidates are those with the
    smallest |logit| by a stable ascending sort, so on ties the lower index
    comes first."""
    n = pred_masks.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    num_uncertain = int(importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    coords = draws.uniform('oversample', layer, (n, num_sampled, 2), pred_masks.device)
    point_logits = _sample_points_batch(pred_masks, coords)
    order = torch.sort(point_logits.abs(), dim=-1, stable=True).indices[:, :num_uncertain]
    picked = torch.gather(coords, 1, order[..., None].expand(-1, -1, 2))
    if num_random > 0:
        extra = draws.uniform('redraw', layer, (n, num_random, 2), pred_masks.device)
        picked = torch.cat([picked, extra], dim=1)
    return picked


def mask2former_loss(masks_queries_logits: torch.Tensor, class_queries_logits: torch.Tensor,
                     target_masks: torch.Tensor, target_classes: torch.Tensor,
                     target_valid: torch.Tensor, assigned: torch.Tensor, draws: PointDraws,
                     layer: int = 0, *, num_labels: int, no_object_weight: float = 0.1,
                     train_num_points: int = 12544, oversample_ratio: float = 3.0,
                     importance_sample_ratio: float = 0.75, loss_key_suffix: str = '',
                     sample_valid: torch.Tensor | None = None,
                     num_masks_reduce: Reduce | None = None,
                     class_weight_reduce: Reduce | None = None,
                     ) -> dict[str, torch.Tensor]:
    """One layer's unweighted loss dict {loss_mask, loss_dice,
    loss_cross_entropy} for the matcher's ``assigned`` (B, N_max) queries
    (:func:`hungarian_match`). ``sample_valid`` (B,) excludes batch-padding
    repeats from every term. ``num_masks_reduce`` maps the local target
    count to the mask and dice losses' normaliser (default max(count, 1))
    and ``class_weight_reduce`` the local CE weight sum to the CE's
    (default max(Σw, 1e-8)); a data-parallel run passes the global ones
    over its rank count (``parallel/mesh.py::loss_reducers``)."""
    b, q, _ = class_queries_logits.shape
    n_max = target_masks.shape[1]
    if sample_valid is not None:
        target_valid = target_valid & (sample_valid > 0)[:, None]

    num_masks = target_valid.sum().float()
    num_masks = num_masks.clamp(min=1.0) if num_masks_reduce is None else num_masks_reduce(
        num_masks)

    # ---- loss_labels (HF:547-580) ----
    batch_idx = torch.arange(b, device=assigned.device)[:, None].expand(b, n_max)
    safe_assigned = assigned.clamp(0, q - 1)
    target_map = torch.full((b, q), num_labels, dtype=torch.long,
                            device=class_queries_logits.device)
    # the LAP gives each slot a distinct query; invalid slots write no-object
    target_map[batch_idx, safe_assigned] = torch.where(
        target_valid, target_classes.long(), num_labels)
    log_probs = torch.log_softmax(class_queries_logits, dim=-1)
    picked = torch.gather(log_probs, -1, target_map[..., None])[..., 0]
    weights = torch.ones(num_labels + 1, device=log_probs.device)
    weights[num_labels] = no_object_weight
    class_w = weights[target_map]
    if sample_valid is not None:
        class_w = class_w * sample_valid[:, None]
    weight_sum = class_w.sum()
    weight_sum = (weight_sum.clamp(min=1e-8) if class_weight_reduce is None
                  else class_weight_reduce(weight_sum))
    loss_ce = -(class_w * picked).sum() / weight_sum

    # ---- loss_masks (HF:581-640) ----
    flat_pred = masks_queries_logits.reshape(b * q, *masks_queries_logits.shape[2:])
    pred = flat_pred[(batch_idx * q + safe_assigned).reshape(-1)]  # (B·N_max, Hp, Wp)
    tgt = target_masks.reshape(b * n_max, *target_masks.shape[2:])
    valid = target_valid.reshape(-1)
    coords = _uncertainty_points(pred.detach(), draws, layer, train_num_points,
                                 oversample_ratio, importance_sample_ratio)
    point_logits = _sample_points_batch(pred, coords)
    with torch.no_grad():
        point_labels = _sample_points_batch(tgt, coords)

    bce = F.softplus(point_logits) - point_logits * point_labels
    loss_mask = torch.where(valid, bce.mean(-1), 0.0).sum() / num_masks
    probs = torch.sigmoid(point_logits)
    numerator = 2.0 * (probs * point_labels).sum(-1)
    denominator = probs.sum(-1) + point_labels.sum(-1)
    dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    loss_dice = torch.where(valid, dice, 0.0).sum() / num_masks

    s = loss_key_suffix
    return {f'loss_mask{s}': loss_mask, f'loss_dice{s}': loss_dice,
            f'loss_cross_entropy{s}': loss_ce}


def total_loss(outputs: Any, target_masks: torch.Tensor, target_classes: torch.Tensor,
               target_valid: torch.Tensor, draws: PointDraws, *, num_labels: int,
               no_object_weight: float = 0.1, train_num_points: int = 12544,
               oversample_ratio: float = 3.0, importance_sample_ratio: float = 0.75,
               class_weight: float = 2.0, mask_weight: float = 5.0, dice_weight: float = 5.0,
               use_auxiliary_loss: bool = True, sample_valid: torch.Tensor | None = None,
               num_masks_reduce: Reduce | None = None,
               class_weight_reduce: Reduce | None = None,
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted total loss over the final layer and every aux layer of a
    ``Mask2FormerOutput`` → (scalar total, weighted per-key dict), in
    float32. ``target_masks`` (B, N_max, H, W) binary, ``target_classes``
    (B, N_max), ``target_valid`` (B, N_max) bool."""
    layers = [(outputs.masks_queries_logits, outputs.class_queries_logits, '')]
    if use_auxiliary_loss:
        layers += [(m, c, f'_{i}') for i, (m, c) in enumerate(
            zip(outputs.aux_masks_queries_logits, outputs.aux_class_queries_logits))]
    device = target_masks.device
    with torch.autocast(device.type, enabled=False):
        layers = [(m.float(), c.float(), suffix) for m, c, suffix in layers]
        target_masks = target_masks.float()
        tv = target_valid if sample_valid is None else target_valid & (sample_valid > 0)[:, None]

        # every layer's assignment after one device→host copy
        b = target_masks.shape[0]
        costs = torch.stack([
            matcher_cost(m.detach(), c.detach(), target_masks, target_classes, tv,
                         draws.uniform('matcher', i, (b, train_num_points, 2), device),
                         class_weight, mask_weight, dice_weight)
            for i, (m, c, _) in enumerate(layers)])  # (L, B, N, Q)
        assigned = hungarian_match(costs)

        losses: dict[str, torch.Tensor] = {}
        for i, (m, c, suffix) in enumerate(layers):
            losses.update(mask2former_loss(
                m, c, target_masks, target_classes, target_valid, assigned[i], draws, i,
                num_labels=num_labels, no_object_weight=no_object_weight,
                train_num_points=train_num_points, oversample_ratio=oversample_ratio,
                importance_sample_ratio=importance_sample_ratio, loss_key_suffix=suffix,
                sample_valid=sample_valid, num_masks_reduce=num_masks_reduce,
                class_weight_reduce=class_weight_reduce))
    weight_map = {'loss_cross_entropy': class_weight, 'loss_mask': mask_weight,
                  'loss_dice': dice_weight}
    weighted = {}
    for key, value in losses.items():
        for sub, w in weight_map.items():
            if sub in key:
                value = value * w
        weighted[key] = value
    return sum(weighted.values()), weighted
