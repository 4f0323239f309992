"""Plain instance post-process (HF ``post_process_instance_segmentation``):
class probabilities by softmax without the no-object class, the Q best
(query, label) pairs by probability, mask logits bilinearly upsampled to
384², a binary mask where a logit is positive, the mask score as the mean
sigmoid inside it, the final score as their product; a slot is kept where
that reaches the threshold and its mask is not empty, kept slots take the
segment ids 0, 1, … in slot order, and each kept slot's mask in turn
writes its id over the segmentation map, nearest-resized to the target."""

from __future__ import annotations

import torch
import torch.nn.functional as F

SCORE_HW = (384, 384)
TIE_SCORE = 0.05  # a score or class probability this close to another may fall on either side


@torch.no_grad()
def answers(class_logits: torch.Tensor, mask_logits: torch.Tensor, target_hw: tuple,
            threshold: float) -> dict:
    """(B, Q, C+1), (B, Q, Hm, Wm) → the serving arrays (``scores``,
    ``labels``, ``valid`` (B, Q); ``segment_ids`` (B, Q), -1 where not
    kept; ``segmentation`` (B, H, W), -1 where no kept slot covers), with
    ``cover`` (B, H, W) bool, and ``margin`` (B, H, W): how far the
    reference's mask logits lie from changing each pixel's owner, the least
    |logit| at the pixel of the owner and of every kept or nearly kept slot
    that writes after it (whose logit, pushed across 0, would take the
    pixel or give it up); 0 where a slot that writes after the owner (or
    the owner) lies within ``TIE_SCORE`` of the threshold and covers the
    pixel, or where the owner and the slot it wrote over lie within
    ``TIE_SCORE`` in class probability."""
    b, q, c1 = class_logits.shape
    probs = class_logits.float().softmax(-1)[..., :-1]
    dev = mask_logits.device
    rows = torch.floor(torch.arange(target_hw[0], device=dev)
                       * (SCORE_HW[0] / target_hw[0])).long()
    cols = torch.floor(torch.arange(target_hw[1], device=dev)
                       * (SCORE_HW[1] / target_hw[1])).long()
    out = {k: [] for k in ('scores', 'labels', 'valid', 'segment_ids', 'segmentation',
                           'cover', 'margin')}
    for i in range(b):
        top, idx = torch.sort(probs[i].flatten(), descending=True, stable=True)
        top, query, label = top[:q], idx[:q] // (c1 - 1), idx[:q] % (c1 - 1)
        up = F.interpolate(mask_logits[i:i + 1].float(), size=SCORE_HW, mode='bilinear',
                           align_corners=False)[0]  # (Q, 384, 384)
        binary = up > 0
        mask_score = (up.sigmoid() * binary).flatten(1).sum(-1) / (binary.flatten(1).sum(-1)
                                                                  + 1e-6)
        score = top * mask_score[query]
        nonempty = binary.flatten(1).any(-1)[query]
        keep = (score >= threshold) & nonempty
        seg_ids = torch.where(keep, torch.cumsum(keep, 0) - 1, -1)
        owner = torch.full(SCORE_HW, -1, dtype=torch.long, device=dev)
        under = torch.full(SCORE_HW, -1, dtype=torch.long, device=dev)
        for j in torch.nonzero(keep).flatten().tolist():  # each kept slot writes in turn
            m = binary[query[j]]
            under = torch.where(m, owner, under)
            owner = torch.where(m, j, owner)
        margin = torch.full(SCORE_HW, float('inf'), device=dev)
        edge = ((score - threshold).abs() < TIE_SCORE) & nonempty
        for j in torch.nonzero((score >= threshold - TIE_SCORE) & nonempty).flatten().tolist():
            later = owner <= j  # a slot that writes after the owner, or the owner
            margin = torch.where(later, torch.minimum(margin, up[query[j]].abs()), margin)
            if bool(edge[j]):
                margin = torch.where(later & binary[query[j]], 0.0, margin)
        order = (under >= 0) & (top[under.clamp(min=0)] - top[owner.clamp(min=0)] < TIE_SCORE)
        margin = torch.where(order, 0.0, margin)
        seg = torch.where(owner >= 0, seg_ids[owner.clamp(min=0)], -1)
        for key, value in (('scores', score), ('labels', label), ('valid', keep),
                           ('segment_ids', seg_ids), ('segmentation', seg[rows][:, cols]),
                           ('cover', (owner >= 0)[rows][:, cols]),
                           ('margin', margin[rows][:, cols])):
            out[key].append(value)
    return {k: torch.stack(v) for k, v in out.items()}
