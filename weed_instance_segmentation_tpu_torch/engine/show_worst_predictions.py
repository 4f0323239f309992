"""The test images a model gets most wrong, by per-image mAP.

    python -m weed_instance_segmentation_tpu_torch.engine.show_worst_predictions

Port of ``weed_instance_segmentation_tpu/engine/show_worst_predictions.py``.
:func:`score_images` scores every test image on its own: a forward of batch
1, the post-process at threshold 0.5 and the image's COCO mAP through one
metric's reset/update/compute cycle per image (the reference's quirk), then
an ascending stable sort. ``main()`` loads ``WISTPU_MODEL_ID`` in
``config.COMPUTE_DTYPE``, scores the test split of ``config.DATASET_LIST[0]``
(its ``Processed/Test`` cache where one exists, else the raw test folder),
prints the ``WISTPU_N_WORST`` worst, and draws each one's prediction (a new
:func:`~.inference.run_inference` of the raw image) beside its ground truth
into ``config.OUTPUT_DIR/worst_<i>_<name>.png``.

It runs on the card; ``WISTPU_DEVICE=cpu`` asks for the CPU. The scoring
needs neither PIL nor matplotlib when it reads a cache, so the card runs
:func:`score_images`; the drawing half needs both.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import (
    PreprocessedDataset, collate_fn,
)
from weed_instance_segmentation_tpu_torch.datasets.factory import get_dataset_and_config
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.engine.inference import run_inference
from weed_instance_segmentation_tpu_torch.engine.metrics import (
    predictions_from_postprocess, targets_from_original_maps,
)
from weed_instance_segmentation_tpu_torch.engine.model_utils import (
    load_model, plot_segmentation, resolve_model_path,
)
from weed_instance_segmentation_tpu_torch.engine.steps import make_forward_fn
from weed_instance_segmentation_tpu_torch.evaluation.mean_ap import MeanAveragePrecision
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    post_process_instance_segmentation,
)

N_WORST = int(os.environ.get('WISTPU_N_WORST', 3))
MODEL_ID = os.environ.get('WISTPU_MODEL_ID', 'mask2former_fine_tuned/latest/best_model/')


def convert_gt_map_to_result(gt_map, id_mapping) -> dict:
    """Instance map and its id → label mapping → a result dict for
    ``plot_segmentation`` (score 1.0; 255 and unmapped ids left out)."""
    segments_info = [
        {'id': int(uid), 'label_id': id_mapping[int(uid)], 'score': 1.0}
        for uid in np.unique(gt_map)
        if uid != 255 and int(uid) in id_mapping
    ]
    return {'segmentation': gt_map, 'segments_info': segments_info}


def score_images(forward_fn, dataset, device: str | torch.device = 'cuda') -> list[dict]:
    """Each sample of ``dataset`` (cache or raw reader) scored on its own:
    ``[{'score', 'file_name', 'original_map', 'id_mapping'}, …]`` in
    ascending order of per-image mAP (stable, so ties keep the dataset's
    order). ``forward_fn`` is ``make_forward_fn`` of a model on ``device``."""
    data_loader = DataLoader(dataset, batch_size=1, collate=collate_fn, shuffle=False)
    scored_images = []
    metric = MeanAveragePrecision(iou_type='segm', device=device)
    print(f'\nEvaluating {len(dataset)} images...')
    for i, batch in enumerate(data_loader):
        if (i + 1) % 5 == 0:
            print(f'  Processing {i + 1}/{len(dataset)}...', end='\r')
        outputs = forward_fn(torch.from_numpy(np.asarray(batch['pixel_values'])).to(device))
        predictions = post_process_instance_segmentation(
            outputs, threshold=0.5, mask_threshold=0.5,
            target_sizes=batch['target_sizes'],
        )
        formatted_preds = predictions_from_postprocess(predictions)
        targets = targets_from_original_maps(batch['original_maps'], batch['id_mappings'])

        metric.reset()
        metric.update(formatted_preds, targets)
        score = float(metric.compute()['map'])

        scored_images.append({
            'score': score,
            'file_name': batch['file_names'][0],
            'original_map': batch['original_maps'][0],
            'id_mapping': batch['id_mappings'][0],
        })
    scored_images.sort(key=lambda x: x['score'])
    return scored_images


def main(model_id: str = MODEL_ID, n_worst: int = N_WORST, show: bool = True,
         device: str | torch.device = 'cuda'):
    model, cfg = load_model(model_id, device)
    processor = ckpt.load_processor(resolve_model_path(model_id))
    forward_fn = make_forward_fn(model)

    WeedDataset, ds_config = get_dataset_and_config(config.DATASET_LIST[0])

    test_processed_path = os.path.join(ds_config.PROCESSED_DIR, 'Test')
    if os.path.exists(test_processed_path) and len(os.listdir(test_processed_path)) > 0:
        print(f'Loading pre-processed test data from "{test_processed_path}"')
        test_dataset = PreprocessedDataset(test_processed_path)
    else:
        print('Loading raw test data...')
        test_dataset = WeedDataset(
            image_folder_path=ds_config.TEST_IMG_DIR,
            annotation_path=ds_config.TEST_ANNOTATIONS,
            processor=processor,
            label2id=ds_config.LABEL2ID,
        )
    if len(test_dataset) == 0:
        print('No test data found.')
        return []

    worst_cases = score_images(forward_fn, test_dataset, device)[:n_worst]

    print(f'\n\n--- Top {n_worst} Worst Predictions (by mAP) ---')
    for case in worst_cases:
        print(f'File: {case["file_name"]} | mAP: {case["score"]:.4f}')

    import matplotlib

    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    print('\nVisualizing...')
    for idx, case in enumerate(worst_cases):
        file_name = case['file_name']
        img_path = os.path.join(ds_config.TEST_IMG_DIR, file_name)
        if not os.path.exists(img_path):
            print(f'Image not found: {img_path}')
            continue
        image, result = run_inference(img_path, forward_fn, processor, device)
        gt_result = convert_gt_map_to_result(case['original_map'], case['id_mapping'])

        fig, axes = plt.subplots(1, 2, figsize=(20, 10))
        plot_segmentation(image, result, cfg.id2label, ax=axes[0],
                          title=f'Prediction (mAP: {case["score"]:.2f})', show=False)
        plot_segmentation(image, gt_result, cfg.id2label, ax=axes[1],
                          title='Ground Truth', show=False)
        plt.tight_layout()
        if show and os.environ.get('DISPLAY'):
            plt.show()
        else:
            out = os.path.join(config.OUTPUT_DIR,
                               f'worst_{idx}_{os.path.splitext(file_name)[0]}.png')
            os.makedirs(config.OUTPUT_DIR, exist_ok=True)
            fig.savefig(out)
            print(f'Saved visualization to {out}')
        plt.close(fig)
    return worst_cases


if __name__ == '__main__':
    main(MODEL_ID, N_WORST, device=os.environ.get('WISTPU_DEVICE', 'cuda'))
