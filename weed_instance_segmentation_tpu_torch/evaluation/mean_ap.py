"""COCO-style instance-segmentation mAP.

Port of ``weed_instance_segmentation_tpu/evaluation/mean_ap.py``, an
API-compatible stand-in for ``torchmetrics.detection.MeanAveragePrecision
(iou_type='segm')`` that follows the COCO evaluation protocol (pycocotools
COCOeval, iouType='segm'):

- IoU thresholds 0.50:0.05:0.95 on masks; 101-point interpolated PR;
- per-(image, class, area-range) greedy matching: predictions in
  score-descending order each claim the still-unmatched GT with the highest
  IoU ≥ t (exact ties → the later GT, as in COCOeval's scan order), with
  GTs outside the area range marked *ignore* and sorted last;
- predictions matched to an ignored GT, or unmatched with area outside the
  range, are ignored (neither TP nor FP);
- max detections 1/10/100 per (image, class) for mar_1/mar_10/mar_100;
- classes with no GT anywhere contribute nothing; empty → -1.0.

The O(N·H·W) work, the pairwise mask intersections, is one (P, HW) @ (HW, G)
product on the device (:func:`mask_iou_matrix`, ``torch.matmul``: the JAX
package's is a plain product too, outside any Pallas kernel). Its inputs are
0/1 and it accumulates in float32, so every count is an exact integer below
2**24 pixels a mask and the card and the CPU give the same bits. The
division, the greedy matching and the PR accumulation are copied by value and
run in numpy on the host, the division in float64 (the rounding of the
quotient decides ties at the thresholds).
"""

from __future__ import annotations

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.engine import trace

IOU_THRESHOLDS = np.round(np.arange(0.50, 1.0, 0.05), 2)  # 10 thresholds
REC_THRESHOLDS = np.linspace(0.0, 1.00, 101)
AREA_RANGES = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _flat_masks(masks, device: torch.device) -> torch.Tensor:
    """(N, H, W) bool numpy or tensor → (N, HW) float32 0/1 on ``device``."""
    t = masks if isinstance(masks, torch.Tensor) else torch.from_numpy(np.asarray(masks, bool))
    return t.reshape(len(t), -1).to(device).float()


def mask_iou_matrix(pred_masks, gt_masks, device: str | torch.device = 'cuda'):
    """Pairwise mask IoU. The intersection product and the areas run on
    ``device`` (the card unless the caller asks for the CPU); the (P, G)
    division runs in float64 on the host.

    pred_masks (P, H, W), gt_masks (G, H, W), bool →
    (iou (P, G) f64, pred_areas (P,) f64, gt_areas (G,) f64) as numpy."""
    n_p, n_g = len(pred_masks), len(gt_masks)
    if n_p == 0 or n_g == 0:
        def area(m):
            m = np.asarray(m, bool)
            return m.reshape(len(m), int(np.prod(m.shape[1:]))).sum(-1).astype(np.float64)
        return np.zeros((n_p, n_g), np.float64), area(pred_masks), area(gt_masks)
    device = torch.device(device)
    p, g = _flat_masks(pred_masks, device), _flat_masks(gt_masks, device)
    inter, pa, ga = (t.cpu().numpy().astype(np.float64) for t in (p @ g.T, p.sum(-1), g.sum(-1)))
    union = pa[:, None] + ga[None, :] - inter
    with np.errstate(invalid='ignore', divide='ignore'):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou, pa, ga


def _greedy_match(iou: np.ndarray, gt_ignore: np.ndarray,
                  thresholds: np.ndarray = IOU_THRESHOLDS) -> np.ndarray:
    """COCOeval.evaluateImg matching, vectorized over IoU thresholds.

    iou (P, G) with P already score-sorted/truncated; gt_ignore (G,) marks
    GTs outside the area range. Returns dtm (T, P) int — matched gt index
    or -1.

    Semantics (all from COCOeval's scan order, where GTs are stably sorted
    ignored-last): a detection takes the highest-IoU still-unmatched
    *in-range* GT with IoU ≥ t if one exists, else the highest-IoU unmatched
    ignored GT; exact IoU ties resolve to the later GT in original order.
    The inner per-GT loop is replaced by two masked arg-maxes per detection
    across all T thresholds at once (the sequential dependency is only over
    detections)."""
    p, g = iou.shape
    t_count = len(thresholds)
    dtm = np.full((t_count, p), -1, np.int64)
    if p == 0 or g == 0:
        return dtm
    gt_ignore = np.asarray(gt_ignore, bool)
    unmatched = np.ones((t_count, g), bool)
    thr = np.minimum(thresholds, 1 - 1e-10)[:, None]  # (T, 1)
    t_idx = np.arange(t_count)
    for di in range(p):
        row = iou[di][None, :]  # (1, G)
        qualifies = unmatched & (row >= thr)  # (T, G)
        for group_mask in (~gt_ignore, gt_ignore):
            cand = qualifies & group_mask[None, :]
            has = cand.any(axis=1)
            if not has.any():
                continue
            # argmax of row within cand, ties → LAST gt (reverse-scan argmax)
            masked = np.where(cand, row, -np.inf)
            pick = (g - 1) - np.argmax(masked[:, ::-1], axis=1)
            take = has & (dtm[:, di] < 0)
            dtm[take, di] = pick[take]
            unmatched[t_idx[take], pick[take]] = False
    return dtm


class MeanAveragePrecision:
    """Drop-in for ``torchmetrics.detection.MeanAveragePrecision`` as used
    by the reference: ``update(preds, target)`` with per-image dicts
    {'masks' (N,H,W) bool, 'scores' (N,), 'labels' (N,)} (preds) and
    {'masks', 'labels'} (target); ``compute()`` → dict of scalar arrays
    (``.item()``-able) + 'classes'; ``reset()``. The intersection products
    run on ``device``, the card unless the caller asks for the CPU."""

    def __init__(self, iou_type: str = 'segm', class_metrics: bool = False,
                 device: str | torch.device = 'cuda'):
        if iou_type != 'segm':
            raise NotImplementedError('only iou_type="segm" is implemented')
        self.class_metrics = class_metrics
        self.device = torch.device(device)  # where the intersection products run
        self.reset()

    def reset(self) -> None:
        # per (image, class): dict(scores, iou, pred_areas, gt_areas)
        self._entries: list[dict] = []
        self._classes: set[int] = set()  # classes with GT (drive the means)
        self._pred_classes: set[int] = set()  # union for the 'classes' key

    def update(self, preds: list[dict], target: list[dict]) -> None:
        for pred, tgt in zip(preds, target):
            p_masks = np.asarray(_to_np(pred['masks']), bool)
            p_scores = np.asarray(_to_np(pred['scores']), np.float32)
            p_labels = np.asarray(_to_np(pred['labels']), np.int64)
            g_masks = np.asarray(_to_np(tgt['masks']), bool)
            g_labels = np.asarray(_to_np(tgt['labels']), np.int64)

            classes = set(p_labels.tolist()) | set(g_labels.tolist())
            self._classes |= set(g_labels.tolist())
            self._pred_classes |= set(p_labels.tolist())
            per_class = {}
            for c in classes:
                pi = np.nonzero(p_labels == c)[0]
                gi = np.nonzero(g_labels == c)[0]
                order = np.argsort(-p_scores[pi], kind='stable')
                pi = pi[order]
                with trace.span('IoU product'):
                    iou, pa, ga = mask_iou_matrix(p_masks[pi], g_masks[gi], self.device)
                per_class[int(c)] = {
                    'scores': p_scores[pi],
                    'iou': iou,
                    'pred_areas': pa,
                    'gt_areas': ga,
                }
            self._entries.append(per_class)

    def compute(self) -> dict:
        classes = sorted(self._classes | self._pred_classes)
        t_count = len(IOU_THRESHOLDS)
        # precision[T, R, K, A, M], recall[T, K, A, M]
        shape_p = (t_count, len(REC_THRESHOLDS), len(classes), len(AREA_RANGES), len(MAX_DETS))
        precision = -np.ones(shape_p)
        recall = -np.ones((t_count, len(classes), len(AREA_RANGES), len(MAX_DETS)))

        for ki, c in enumerate(classes):
            per_img = [entry[c] for entry in self._entries if c in entry]
            # matching depends on the area range only through the GT-ignore
            # pattern (COCOeval evaluateImg sorts out-of-range GTs last);
            # cache per image by that pattern — the 'all' range and any
            # bucket where every GT is in/out of range share one match
            dtm_cache: list[dict[bytes, np.ndarray]] = [{} for _ in per_img]
            for ai, (a_lo, a_hi) in enumerate(AREA_RANGES.values()):
                matched_imgs = []
                for e, cache in zip(per_img, dtm_cache):
                    ga = e['gt_areas']
                    gt_ig = (ga < a_lo) | (ga > a_hi)
                    key = gt_ig.tobytes()
                    dtm = cache.get(key)
                    if dtm is None:
                        dtm = _greedy_match(e['iou'][: MAX_DETS[-1]], gt_ig)
                        cache[key] = dtm
                    matched_imgs.append((e, gt_ig, dtm))

                for mi, max_det in enumerate(MAX_DETS):
                    scores_all, tps_all, igs_all = [], [], []
                    npig = 0
                    for e, gt_ig, dtm_full in matched_imgs:
                        ga = e['gt_areas']
                        npig += int((~gt_ig).sum())
                        n_dt = min(len(e['scores']), max_det)
                        if n_dt == 0:
                            continue
                        dtm = dtm_full[:, :n_dt]
                        pa = e['pred_areas'][:n_dt]
                        matched = dtm >= 0
                        # ignore: matched to an ignored gt, or unmatched with
                        # out-of-range area (COCOeval dtIg)
                        safe = np.clip(dtm, 0, max(len(ga) - 1, 0))
                        m_ig = np.where(matched, gt_ig[safe] if len(ga) else False, False)
                        out_of_range = (pa < a_lo) | (pa > a_hi)
                        dt_ig = m_ig | (~matched & out_of_range[None, :])
                        scores_all.append(e['scores'][:n_dt])
                        tps_all.append(matched & ~dt_ig)
                        igs_all.append(dt_ig)
                    if npig == 0:
                        continue
                    if scores_all:
                        scores = np.concatenate(scores_all)
                        order = np.argsort(-scores, kind='mergesort')
                        tps = np.concatenate(tps_all, axis=1)[:, order]
                        igs = np.concatenate(igs_all, axis=1)[:, order]
                        fps = ~tps & ~igs
                        tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                        fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                        for ti in range(t_count):
                            tp, fp = tp_cum[ti], fp_cum[ti]
                            rc = tp / npig
                            pr = tp / (fp + tp + np.spacing(1))
                            recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                            # precision envelope (monotone non-increasing)
                            pr = np.maximum.accumulate(pr[::-1])[::-1]
                            inds = np.searchsorted(rc, REC_THRESHOLDS, side='left')
                            q = np.zeros(len(REC_THRESHOLDS))
                            in_range = inds < len(pr)
                            q[in_range] = pr[inds[in_range]]
                            precision[ti, :, ki, ai, mi] = q
                    else:
                        recall[:, ki, ai, mi] = 0.0
                        precision[:, :, ki, ai, mi] = 0.0

        def _ap(t_slice=slice(None), area='all', max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = precision[t_slice, :, :, ai, mi]
            valid = s > -1
            return np.float32(s[valid].mean()) if valid.any() else np.float32(-1.0)

        def _ar(area='all', max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = recall[:, :, ai, mi]
            valid = s > -1
            return np.float32(s[valid].mean()) if valid.any() else np.float32(-1.0)

        t50 = int(np.argwhere(np.isclose(IOU_THRESHOLDS, 0.5))[0][0])
        t75 = int(np.argwhere(np.isclose(IOU_THRESHOLDS, 0.75))[0][0])
        result = {
            'map': _ap(),
            'map_50': _ap(slice(t50, t50 + 1)),
            'map_75': _ap(slice(t75, t75 + 1)),
            'map_small': _ap(area='small'),
            'map_medium': _ap(area='medium'),
            'map_large': _ap(area='large'),
            'mar_1': _ar(max_det=1),
            'mar_10': _ar(max_det=10),
            'mar_100': _ar(max_det=100),
            'mar_small': _ar(area='small'),
            'mar_medium': _ar(area='medium'),
            'mar_large': _ar(area='large'),
            'classes': np.asarray(classes, np.int32),
        }
        ai_all, mi_100 = 0, MAX_DETS.index(100)
        if self.class_metrics and classes:
            per_cls_ap, per_cls_ar = [], []
            for ki in range(len(classes)):
                s = precision[:, :, ki, ai_all, mi_100]
                r = recall[:, ki, ai_all, mi_100]
                per_cls_ap.append(s[s > -1].mean() if (s > -1).any() else -1.0)
                per_cls_ar.append(r[r > -1].mean() if (r > -1).any() else -1.0)
            result['map_per_class'] = np.asarray(per_cls_ap, np.float32)
            result['mar_100_per_class'] = np.asarray(per_cls_ar, np.float32)
        else:
            result['map_per_class'] = np.float32(-1.0)
            result['mar_100_per_class'] = np.float32(-1.0)
        return result


def _to_np(x):
    if hasattr(x, 'detach'):  # torch tensor
        return x.detach().cpu().numpy()
    return np.asarray(x)
