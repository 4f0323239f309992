"""Single-image inference, and the image's ground truth for comparison.

    python -m weed_instance_segmentation_tpu_torch.engine.inference

Port of ``weed_instance_segmentation_tpu/engine/inference.py``.
:func:`run_inference` reads an image file, resizes its long side to
``config.MAX_INPUT_DIM`` (PIL bilinear), runs the checkpoint's image
processor, the model's forward and the instance post-process at the resized
image's size. It is split so that everything after decoding runs without
PIL: :func:`run_inference_array` takes the decoded HWC uint8 array, and
needs PIL only where a resize runs (the long-side resize, or the
processor's when the array is not at its output size). The card has no PIL,
so it drives the array form.

:func:`load_ground_truth` rasterises an image's VGG-JSON polygons
(sorghum_weed's format) into a result dict at a given (W, H).

``main()`` loads ``WISTPU_MODEL_ID`` (under ``config.MODELS_OUTPUT_DIR``; a
``latest`` component resolves to the newest run) in
``config.COMPUTE_DTYPE``, runs ``WISTPU_IMAGE_PATH`` and draws the
prediction (and, with ``WISTPU_GT_ANNOTATION_PATH``, the ground truth of
``config.DATASET_LIST[0]``'s test split beside it) into
``config.OUTPUT_DIR/inference.png``, or shows it where ``DISPLAY`` is set.
It runs on the card; ``WISTPU_DEVICE=cpu`` asks for the CPU. PIL and
matplotlib are imported only inside the functions that read an image file
or draw.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets.factory import get_dataset_and_config
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.engine.model_utils import (
    load_model, plot_segmentation, resolve_model_path,
)
from weed_instance_segmentation_tpu_torch.engine.steps import make_forward_fn
from weed_instance_segmentation_tpu_torch.ops.rasterize import fill_poly
from weed_instance_segmentation_tpu_torch.ops.resize import pil_resize_image
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    post_process_instance_segmentation,
)

MODEL_ID = os.environ.get('WISTPU_MODEL_ID', 'mask2former_fine_tuned/latest/best_model/')
IMAGE_PATH = os.environ.get('WISTPU_IMAGE_PATH', 'data/reference_images/pic1.jpeg')
GROUND_TRUTH_ANNOTATION_PATH = os.environ.get('WISTPU_GT_ANNOTATION_PATH') or None


def run_inference_array(image: np.ndarray, forward_fn, processor,
                        device: str | torch.device = 'cuda') -> tuple[np.ndarray, dict]:
    """(resized HWC uint8 image, result dict) of a decoded RGB image: its
    long side cut to ``config.MAX_INPUT_DIM`` (PIL bilinear to
    ``(int(w * scale), int(h * scale))``), then the processor, ``forward_fn``
    (``engine/steps.py::make_forward_fn`` of a model on ``device``) and the
    post-process at the resized image's (H, W), threshold 0.5."""
    image = np.asarray(image)
    h, w = image.shape[:2]
    if max(w, h) > config.MAX_INPUT_DIM:
        scale = config.MAX_INPUT_DIM / max(w, h)
        image = pil_resize_image(image, (int(h * scale), int(w * scale)))
    inputs = processor(images=image, return_tensors='np')
    outputs = forward_fn(torch.from_numpy(inputs['pixel_values']).to(device))
    result = post_process_instance_segmentation(outputs, target_sizes=[image.shape[:2]])[0]
    return image, result


def run_inference(image_path: str, forward_fn, processor,
                  device: str | torch.device = 'cuda'):
    """(resized PIL image, result dict) of the image file ``image_path``, as
    :func:`run_inference_array` computes them."""
    from PIL import Image

    with Image.open(image_path) as f:
        image = np.asarray(f.convert('RGB'))
    resized, result = run_inference_array(image, forward_fn, processor, device)
    return Image.fromarray(resized), result


def load_ground_truth(
    image_name: str,
    target_size: tuple,
    annotation_file: str,
    img_dir: str,
    label2id: dict,
) -> dict | None:
    """VGG-JSON polygons of ``image_name`` → result dict at ``target_size``
    (W, H), instance ids from 1 and score 1.0; ``None`` (with a message)
    where the annotation file is missing or unreadable or has no entry for
    the image. The polygons are scaled from the original image's size in
    ``img_dir`` (read with PIL); without the original they are taken as
    already at ``target_size``."""
    if not os.path.exists(annotation_file):
        print(f'GT annotation file missing, skipping comparison: {annotation_file}')
        return None
    try:
        with open(annotation_file) as f:
            data = json.load(f)
    except Exception as e:
        print(f'Could not parse GT annotation JSON ({annotation_file}): {e}')
        return None

    base = os.path.basename(image_name)
    entry = next((item for item in data.values() if item['filename'] == base), None)
    if not entry:
        print(f'{base!r} has no entry in the GT annotation file')
        return None

    image_path = os.path.join(img_dir, base)
    if os.path.exists(image_path):
        from PIL import Image

        with Image.open(image_path) as orig:
            orig_w, orig_h = orig.size
    else:
        print(f'Original image missing ({image_path}); using 1:1 polygon scale')
        orig_w, orig_h = target_size

    target_w, target_h = target_size
    scale_x = target_w / orig_w
    scale_y = target_h / orig_h

    segmentation = np.zeros((target_h, target_w), np.int32)
    segments_info = []
    current_instance_id = 1
    for region in entry.get('regions', []):
        shape_attr = region['shape_attributes']
        class_name = region['region_attributes'].get('classname')
        if shape_attr['name'] != 'polygon' or class_name not in label2id:
            continue
        points = np.asarray(
            [[int(x * scale_x), int(y * scale_y)]
             for x, y in zip(shape_attr['all_points_x'], shape_attr['all_points_y'])],
            np.int32,
        )
        segmentation = fill_poly(segmentation, points, current_instance_id)
        segments_info.append({'id': current_instance_id, 'label_id': label2id[class_name],
                              'score': 1.0})
        current_instance_id += 1
    return {'segmentation': segmentation, 'segments_info': segments_info}


def main(model_id: str = MODEL_ID, image_path: str = IMAGE_PATH,
         gt_annotation_path: str | None = GROUND_TRUTH_ANNOTATION_PATH,
         show: bool = True, device: str | torch.device = 'cuda'):
    model, cfg = load_model(model_id, device)
    processor = ckpt.load_processor(resolve_model_path(model_id))
    forward_fn = make_forward_fn(model)

    if not os.path.exists(image_path):
        print(f'Image not found at {image_path}')
        return None

    img, res = run_inference(image_path, forward_fn, processor, device)

    import matplotlib

    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    if gt_annotation_path:
        _, ds_config = get_dataset_and_config(config.DATASET_LIST[0])
        gt_res = load_ground_truth(
            image_name=image_path,
            target_size=img.size,
            annotation_file=ds_config.TEST_ANNOTATIONS,
            img_dir=ds_config.TEST_IMG_DIR,
            label2id=ds_config.LABEL2ID,
        )
        fig, axes = plt.subplots(1, 2, figsize=(20, 10))
        plot_segmentation(img, res, cfg.id2label, ax=axes[0], title='Prediction', show=False)
        if gt_res is not None:
            plot_segmentation(img, gt_res, cfg.id2label, ax=axes[1], title='Ground Truth',
                              show=False)
        plt.tight_layout()
    else:
        fig, ax = plt.subplots(figsize=(12, 12))
        plot_segmentation(img, res, cfg.id2label, ax=ax, title='Prediction', show=False)
    if show and os.environ.get('DISPLAY'):
        plt.show()
    else:
        out = os.path.join(config.OUTPUT_DIR, 'inference.png')
        os.makedirs(config.OUTPUT_DIR, exist_ok=True)
        fig.savefig(out)
        print(f'Saved visualization to {out}')
    return res


if __name__ == '__main__':
    main(device=os.environ.get('WISTPU_DEVICE', 'cuda'))
