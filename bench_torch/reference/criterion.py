"""Plain Mask2Former training loss and AdamW update (HF
``Mask2FormerLoss`` with its Hungarian matcher, ``torch.optim.AdamW``'s
update written out).

Random points are drawn from the step's generator in a fixed order, which
is part of what a training step is: every loss layer's matcher points
(final layer first, then the auxiliary layers in order), then per layer its
oversampled candidates and its uniform remainder.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from bench_torch.reference.model import MARGINS, tally


def point_sample(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """maps (N, C, H, W) at coords (N, P, 2) in [0, 1] (x, y) → (N, C, P)."""
    return F.grid_sample(maps, (2 * coords - 1)[:, :, None], mode='bilinear',
                         padding_mode='zeros', align_corners=False)[..., 0]


def _uniform(gen: torch.Generator, shape: tuple, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


@torch.no_grad()
def _match(class_logits, mask_logits, masks, classes, coords, cfg) -> list:
    """Per image, (the query matched to each target, the (targets, queries)
    cost matrix)."""
    out = []
    for i in range(class_logits.shape[0]):
        pred = point_sample(mask_logits[i][:, None], coords[i][None].expand(
            mask_logits.shape[1], -1, -1))[:, 0]  # (Q, P)
        tgt = point_sample(masks[i][:, None], coords[i][None].expand(
            masks.shape[1], -1, -1))[:, 0]  # (N, P)
        p = pred.shape[1]
        ce = (F.softplus(-pred) @ tgt.T + F.softplus(pred) @ (1 - tgt).T) / p
        prob = pred.sigmoid()
        dice = 1 - (2 * prob @ tgt.T + 1) / (prob.sum(-1)[:, None] + tgt.sum(-1)[None] + 1)
        cls = -class_logits[i].softmax(-1)[:, classes[i]]
        cost = cfg['mask_weight'] * ce + cfg['class_weight'] * cls + cfg['dice_weight'] * dice
        rows, cols = linear_sum_assignment(cost.T.cpu().numpy())  # targets → queries
        assigned = np.empty(len(rows), np.int64)
        assigned[rows] = cols
        out.append((torch.from_numpy(assigned).to(class_logits.device), cost.T))
    return out


def total_loss(class_list: list, mask_list: list, masks: torch.Tensor, classes: torch.Tensor,
               gen: torch.Generator, cfg: dict, probe: dict | None = None) -> torch.Tensor:
    """The weighted loss summed over the final layer and every auxiliary
    layer. ``masks`` (B, N, H, W) float, ``classes`` (B, N): every target
    real. ``probe``, where given, receives the assignment used
    (``assigned``, (layers, B, N)); with ``forced`` in it, that assignment
    is used instead of the reference's own, and ``match_excess`` holds each
    (layer, image) problem's excess of its cost over the optimal one, under
    the reference's costs, a target (``match_gap`` the largest; an
    assignment of another shape cannot be followed and reads inf); with
    ``points`` in it (a layer's (B·N, P, 2) point coordinates), those are
    sampled instead of the reference's own, and ``point_flips`` of
    ``point_decisions`` are not the reference's own choice: an uncertain
    point whose |logit| lies above the reference's own cut (the largest
    |logit| it keeps), or a uniform one other than its own draw;
    ``point_tally`` counts them by that excess (``tally``; a uniform one
    above every edge), and ``point_gap`` is the largest excess."""
    layers = [(class_list[-1], mask_list[-1])] + list(zip(class_list[:-1], mask_list[:-1]))
    b, n = classes.shape
    p = cfg['train_num_points']
    dev = masks.device
    found = [_match(c.detach(), m.detach(), masks, classes, _uniform(gen, (b, p, 2), dev), cfg)
             for c, m in layers]
    matched = [[a for a, _ in layer] for layer in found]
    forced = (probe or {}).get('forced')
    points = (probe or {}).get('points')
    if forced is not None and tuple(forced.shape) != (len(layers), b, n):
        probe['match_gap'], forced = float('inf'), None  # decisions of another batch
        probe['match_excess'] = [float('inf')]
    if points is not None and (len(points) != len(layers) or any(
            tuple(x.shape) != (b * n, p, 2) for x in points)):
        probe['point_gap'], points = float('inf'), None
        probe['point_flips'], probe['point_decisions'] = 1, 0
        probe['point_tally'] = [0] * len(MARGINS) + [1]
    if forced is not None:
        excess = []
        rows = torch.arange(n, device=dev)
        for i, layer in enumerate(found):
            for j, (own, cost) in enumerate(layer):
                take = forced[i, j].to(dev)
                excess.append(float(cost[rows, take].sum() - cost[rows, own].sum()) / n)
        matched = [list(forced[i].to(dev)) for i in range(len(layers))]
        probe['match_gap'], probe['match_excess'] = max(excess), excess
    if probe is not None:
        probe['assigned'] = torch.stack([torch.stack(list(layer)) for layer in matched]).cpu()
    num_masks = max(float(b * n), 1.0)
    labels = cfg['num_labels']
    total = 0.0
    point_gap, used, point_flips = 0.0, [], 0
    counts = [0] * (len(MARGINS) + 1)
    for layer, ((c, m), assigned) in enumerate(zip(layers, matched)):
        q = c.shape[1]
        target = torch.full((b, q), labels, dtype=torch.long, device=dev)
        for i in range(b):
            target[i, assigned[i]] = classes[i].long()
        w = torch.ones(labels + 1, device=dev)
        w[labels] = cfg['no_object_weight']
        ce = F.cross_entropy(c.transpose(1, 2), target, weight=w)
        pred = torch.cat([m[i, assigned[i]] for i in range(b)])  # (B·N, H, W)
        tgt = masks.reshape(b * n, *masks.shape[2:])
        with torch.no_grad():
            cand = _uniform(gen, (b * n, int(p * cfg['oversample_ratio']), 2), dev)
            logits = point_sample(pred[:, None], cand)[:, 0].abs()
            keep = int(cfg['importance_sample_ratio'] * p)
            ranked = torch.sort(logits, dim=-1, stable=True)
            coords = torch.gather(cand, 1, ranked.indices[:, :keep, None].expand(-1, -1, 2))
            if p - keep > 0:
                coords = torch.cat([coords, _uniform(gen, (b * n, p - keep, 2), dev)], 1)
            if points is not None:  # follow the given points; check the uncertain ones
                chosen = points[layer].to(dev)
                near = point_sample(pred[:, None], chosen[:, :keep])[:, 0].abs()
                excess = near - ranked.values[:, keep - 1:keep]
                point_gap = max(point_gap, float(excess.amax().clamp(min=0)))
                redrawn = int((chosen[:, keep:] != coords[:, keep:]).any(-1).sum())
                point_flips += int((excess > 0).sum()) + redrawn
                counts = [a + c for a, c in zip(counts, tally(excess[excess > 0]))]
                counts[-1] += redrawn
                coords = chosen
            used.append(coords.cpu())
            labels_pts = point_sample(tgt[:, None], coords)[:, 0]
        x = point_sample(pred[:, None], coords)[:, 0]
        bce = F.binary_cross_entropy_with_logits(x, labels_pts, reduction='none').mean(-1)
        prob = x.sigmoid()
        dice = 1 - (2 * (prob * labels_pts).sum(-1) + 1) / (prob.sum(-1) + labels_pts.sum(-1) + 1)
        total = total + (cfg['class_weight'] * ce + cfg['mask_weight'] * bce.sum() / num_masks
                         + cfg['dice_weight'] * dice.sum() / num_masks)
    if probe is not None:
        probe['points_used'] = used
        if points is not None:
            probe['point_gap'], probe['point_flips'] = point_gap, point_flips
            probe['point_tally'] = counts
            probe['point_decisions'] = len(layers) * b * n * p
    return total


@torch.no_grad()
def adamw_update(params, state: dict, lr: float, weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW step on each parameter's ``.grad``: decoupled weight decay
    first, then the bias-corrected moments, which ``state`` ({parameter:
    (step, first moment, second moment)}) carries from step to step."""
    for p in params:
        g = p.grad
        step, m, v = state.get(p, (0, torch.zeros_like(p), torch.zeros_like(p)))
        step += 1
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        state[p] = (step, m, v)
        p.mul_(1 - lr * weight_decay)
        p.sub_(lr * (m / (1 - beta1 ** step)) / ((v / (1 - beta2 ** step)).sqrt() + eps))
