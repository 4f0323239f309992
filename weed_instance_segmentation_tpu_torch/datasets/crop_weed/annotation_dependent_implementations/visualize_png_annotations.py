"""crop_weed ground-truth viewer for PNG annotations: each image blended
with its RGB mask (green crop, red weed).

Port of ``weed_instance_segmentation_tpu/datasets/crop_weed/
annotation_dependent_implementations/visualize_png_annotations.py``; PIL is
imported when an image is read.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions
from weed_instance_segmentation_tpu_torch.datasets.visualize_utils import (
    iter_limited, overlay_semantic, show_or_save,
)

LABEL_COLORS = {1: [0, 255, 0], 2: [255, 0, 0]}  # crop green, weed red
LABEL_NAMES = {1: 'crop', 2: 'weed'}


def visualize_dataset(image_folder: str | None = None,
                      annotation_folder: str | None = None,
                      show: bool = True) -> int:
    from PIL import Image

    image_folder = image_folder or definitions.IMG_DIR
    annotation_folder = annotation_folder or definitions.ANNOTATIONS
    if not os.path.exists(annotation_folder):
        print(f'Error: Annotation folder not found at {annotation_folder}')
        return 0

    image_files = sorted(glob.glob(os.path.join(image_folder, '*_image.png')))
    count = 0
    for img_path in iter_limited(image_files):
        file_name = os.path.basename(img_path)
        stem = file_name.split('_')[0]
        ann_path = os.path.join(annotation_folder, f'{stem}_annotation.png')
        if not os.path.exists(ann_path):
            continue
        print(f'Displaying: {file_name}')
        image = np.asarray(Image.open(img_path).convert('RGB'))
        ann = np.asarray(Image.open(ann_path).convert('RGB'))
        semantic = np.zeros(ann.shape[:2], np.uint8)
        semantic[(ann == [0, 255, 0]).all(-1)] = 1  # crop (exact color match)
        semantic[(ann == [255, 0, 0]).all(-1)] = 2  # weed
        fig = overlay_semantic(image, semantic, LABEL_COLORS, LABEL_NAMES,
                               title=f'Ground Truth: {file_name}')
        show_or_save(fig, file_name, show)
        count += 1
    return count


if __name__ == '__main__':
    visualize_dataset()
