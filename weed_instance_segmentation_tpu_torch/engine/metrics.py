"""Evaluation loop: batched COCO mAP over a data loader.

Port of ``weed_instance_segmentation_tpu/engine/metrics.py``. Per batch: the
ground-truth masks and labels are rebuilt from the cached ``original_map``
and ``id_mapping`` on the host (skipping 255 and unmapped ids, an empty
target where none is left); the model's forward runs on the device; the
instance post-process runs on the device, one image at a time at its target
size, at threshold 0.5 by default and mask threshold 0.5; its segments are
reformatted into per-instance mask stacks on the host; and
``MeanAveragePrecision(iou_type='segm')`` accumulates them, with the
intersection products on the device and the matching on the host.

Under data parallelism every rank calls ``test_with_metrics`` with a
process-sharded loader (``datasets/loader.py::DataLoader(process_index=,
process_count=)``): each rank reads, runs and post-processes only its own
rows, the per-image metric entries are gathered and merged in global image
order on rank 0, which alone returns the metrics (the others return
``{}``), as in the JAX package's multi-process path.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.evaluation.mean_ap import MeanAveragePrecision
from weed_instance_segmentation_tpu_torch.parallel.mesh import gather_pyobjects, is_main
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    post_process_instance_segmentation,
)

# the spans of ``test_with_metrics``, in the order a batch runs them; the
# metric update holds ``evaluation/mean_ap.py``'s 'IoU product' span
EVAL_RANGES = ('ground truth', 'forward', 'post-process', 'host reformat', 'metric update',
               'IoU product', 'metric compute')


def targets_from_original_maps(original_maps, id_mappings) -> list[dict]:
    """GT dicts for the metric from cached instance maps."""
    targets = []
    for gt_map, mapping in zip(original_maps, id_mappings):
        gt_map = np.asarray(gt_map)
        masks, labels = [], []
        for uid in np.unique(gt_map):
            if uid == 255 or int(uid) not in mapping:
                continue
            masks.append(gt_map == uid)
            labels.append(mapping[int(uid)])
        if masks:
            targets.append({
                'masks': np.stack(masks),
                'labels': np.asarray(labels, np.int64),
            })
        else:
            targets.append({
                'masks': np.zeros((0, *gt_map.shape), bool),
                'labels': np.zeros((0,), np.int64),
            })
    return targets


def predictions_from_postprocess(predictions: list[dict]) -> list[dict]:
    """Reformat post-processed segments into the metric's input dicts."""
    formatted = []
    for pred in predictions:
        segments_info = pred['segments_info']
        seg = np.asarray(pred['segmentation'])
        if not segments_info:
            formatted.append({
                'masks': np.zeros((0, *seg.shape), bool),
                'scores': np.zeros((0,), np.float32),
                'labels': np.zeros((0,), np.int64),
            })
            continue
        formatted.append({
            'masks': np.stack([seg == info['id'] for info in segments_info]),
            'scores': np.asarray([info['score'] for info in segments_info], np.float32),
            'labels': np.asarray([info['label_id'] for info in segments_info], np.int64),
        })
    return formatted


def test_with_metrics(forward_fn: Callable, data_loader, threshold: float = 0.5,
                      device: str | torch.device = 'cuda',
                      pad_hw: tuple[int, int] | None = None) -> dict:
    """COCO segm mAP over a loader of reference-style ragged batches
    (``datasets/dataset_utils.py::collate_fn``). ``forward_fn(pixel_values)``
    is the inference forward (``engine/steps.py::make_forward_fn``) of a
    model on ``device``. A short last batch runs at its own size (the JAX
    package pads it to keep one compiled shape; the port compiles none).
    Each stage is a span (``EVAL_RANGES``, ``engine/trace.py``), so a
    profiler trace splits the time by stage.

    A loader sharded over several processes makes this a collective of
    them all: each rank runs its real rows (``num_valid``; the repeats
    that pad the global batch are dropped), its pixels zero-padded to
    ``pad_hw`` where given, as every JAX host pads them; rank 0 merges the
    ranks' entries in global image order and returns the metrics, the
    others ``{}``."""
    multiprocess = getattr(data_loader, 'process_count', 1) > 1
    map_metric = MeanAveragePrecision(iou_type='segm', device=device)
    entries_per_batch: list[int] = []
    if is_main():
        print('Calculating Metrics...')
    num_batches = len(data_loader)
    for i, batch in enumerate(data_loader):
        if (i + 1) % 5 == 0 and is_main():
            print(f'  Processing batch {i + 1}/{num_batches}')
        n_valid = int(batch.get('num_valid', len(batch['pixel_values'])))
        entries_per_batch.append(n_valid)
        if n_valid == 0:  # a rank whose rows all pad the last global batch
            continue
        with trace.span('ground truth'):
            targets = targets_from_original_maps(batch['original_maps'][:n_valid],
                                                 batch['id_mappings'][:n_valid])
        with trace.span('forward'):
            pixels = np.asarray(batch['pixel_values'])[:n_valid]
            if multiprocess and pad_hw is not None and pixels.shape[2:] != tuple(pad_hw):
                padded = np.zeros((*pixels.shape[:2], *pad_hw), pixels.dtype)
                padded[:, :, :pixels.shape[2], :pixels.shape[3]] = pixels
                pixels = padded
            outputs = forward_fn(torch.from_numpy(pixels).to(device))
        with trace.span('post-process'):
            predictions = post_process_instance_segmentation(
                outputs, threshold=threshold, mask_threshold=0.5,
                target_sizes=batch['target_sizes'][:n_valid],
            )
        with trace.span('host reformat'):
            formatted = predictions_from_postprocess(predictions)
        with trace.span('metric update'):
            map_metric.update(formatted, targets)
    if multiprocess:
        map_metric = _merge_in_image_order(map_metric, entries_per_batch, device)
        if map_metric is None:
            return {}
    with trace.span('metric compute'):
        return map_metric.compute()


def _merge_in_image_order(map_metric: MeanAveragePrecision, entries_per_batch: list[int],
                          device) -> MeanAveragePrecision | None:
    """Every rank's per-image entries (a collective), merged on rank 0 in
    global image order (batch-major, rank-minor: each rank's rows of global
    batch i are contiguous), so the final stable score sort is a single
    process's; None on the other ranks."""
    payloads = gather_pyobjects({
        'entries': map_metric._entries,
        'counts': entries_per_batch,
        'classes': sorted(map_metric._classes),
        'pred_classes': sorted(map_metric._pred_classes),
    })
    if not is_main():
        return None
    merged = MeanAveragePrecision(iou_type='segm', device=device)
    iters = [iter(p['entries']) for p in payloads]
    for bi in range(max(len(p['counts']) for p in payloads)):
        for it, p in zip(iters, payloads):
            if bi < len(p['counts']):
                merged._entries.extend(next(it) for _ in range(p['counts'][bi]))
    for p in payloads:
        merged._classes |= set(p['classes'])
        merged._pred_classes |= set(p['pred_classes'])
    return merged


def print_metrics_evaluation(metrics_evaluation: dict, model_name: str = 'Model') -> None:
    """Console summary: mAP, mAP at IoU 0.50 and at 0.75, in percent."""
    print(f'\n--- {model_name} Metrics ---')
    if not metrics_evaluation:
        print('No metrics calculated.')
        return

    def get_scalar(key) -> float:
        val = metrics_evaluation.get(key)
        if val is None:
            return -1.0
        val = np.asarray(val)
        return float(val) if val.size == 1 else -1.0

    print(f'  mAP:            {100 * get_scalar("map"):.2f} %')
    print(f'  mAP (IoU=0.50): {100 * get_scalar("map_50"):.2f} %')
    print(f'  mAP (IoU=0.75): {100 * get_scalar("map_75"):.2f} %')


def prepare_metrics_for_json(results: dict) -> dict | None:
    """Arrays → scalars or lists, for ``json.dump``."""
    if not results:
        return None
    clean = {}
    for key, value in results.items():
        arr = np.asarray(value)
        clean[key] = arr.item() if arr.size == 1 else arr.tolist()
    return clean
