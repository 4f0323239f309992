"""pheno_bench ground-truth viewer: each image with its semantic mask as a
coloured translucent overlay, in the fixed class palette.

Port of ``weed_instance_segmentation_tpu/datasets/pheno_bench/visualize.py``;
PIL is imported when an image is read.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from weed_instance_segmentation_tpu_torch.datasets.pheno_bench import definitions
from weed_instance_segmentation_tpu_torch.datasets.visualize_utils import (
    iter_limited, overlay_semantic, show_or_save,
)

LABEL_COLORS = {
    0: [0, 0, 0],        # background (black)
    1: [0, 255, 0],      # crop (green)
    2: [255, 0, 0],      # weed (red)
    3: [0, 255, 255],    # partial-crop (cyan)
    4: [255, 0, 255],    # partial-weed (magenta)
}


def visualize_dataset(image_folder: str, annotation_folder: str, show: bool = True) -> int:
    if not os.path.exists(annotation_folder):
        print(f'Error: Annotation folder not found at {annotation_folder}')
        return 0

    from PIL import Image

    print(f'Searching for images in {image_folder}...')
    image_files = sorted(glob.glob(os.path.join(image_folder, '*.png')))

    count = 0
    for img_path in iter_limited(image_files):
        file_name = os.path.basename(img_path)
        mask_path = os.path.join(annotation_folder, file_name)
        if not os.path.exists(mask_path):
            continue
        print(f'Displaying: {file_name}')
        image = np.asarray(Image.open(img_path).convert('RGB'))
        semantic = np.asarray(Image.open(mask_path))  # 16-bit semantic ids
        fig = overlay_semantic(
            image, semantic, LABEL_COLORS, definitions.ID2LABEL,
            title=f'Ground Truth: {file_name}',
        )
        show_or_save(fig, file_name, show)
        count += 1
    return count


if __name__ == '__main__':
    visualize_dataset(definitions.TRAIN_IMG_DIR, definitions.TRAIN_ANNOTATIONS)
