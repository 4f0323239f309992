"""pheno_bench reader: 16-bit PNG semantic masks, instances by connected
components.

Port of ``weed_instance_segmentation_tpu/datasets/pheno_bench/dataset.py``:
images paired with same-basename masks; bilinear image and nearest mask
resize to MAX_INPUT_DIM; each class's connected components are its
instances; background class 0 skipped; the mask's pixel values are the
semantic ids.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from weed_instance_segmentation_tpu_torch.datasets.base import (
    IGNORE_INDEX, WeedInstanceDataset, open_rgb, read_image_array, skip_255,
    truncate_to_max_images,
)
from weed_instance_segmentation_tpu_torch.ops.rasterize import connected_components
from weed_instance_segmentation_tpu_torch.ops.resize import pil_resize_mask


class PhenoBenchDataset(WeedInstanceDataset):
    def __init__(self, image_folder_path=None, annotation_path=None, processor=None,
                 label2id=None, **kwargs):
        super().__init__(image_folder_path, annotation_path, processor, label2id, **kwargs)
        image_files = sorted(glob.glob(os.path.join(self.image_folder, '*.png')))

        valid = []
        for img_path in image_files:
            mask_name = os.path.splitext(os.path.basename(img_path))[0] + '.png'
            mask_path = os.path.join(self.annotation_path, mask_name)
            if os.path.exists(mask_path):
                valid.append((img_path, mask_path))
        self.valid_files = truncate_to_max_images(valid)
        print(f'\tLoaded {len(self.valid_files)} valid image/mask pairs from "{self.image_folder}"')

    def _entries(self):
        return self.valid_files

    def _load_sample(self, idx: int):
        image_path, mask_path = self.valid_files[idx]
        image = open_rgb(image_path)
        semantic_mask = read_image_array(mask_path)

        image, _ = self._resize_to_max_dim(image)
        width, height = image.size
        if semantic_mask.shape != (height, width):
            semantic_mask = pil_resize_mask(semantic_mask, (height, width))

        instance_map = np.full((height, width), IGNORE_INDEX, dtype=np.int32)
        id_to_semantic: dict[int, int] = {}
        current_instance_id = 1

        for cls_id in np.unique(semantic_mask):
            if cls_id == 0:
                continue  # background
            class_binary = (semantic_mask == cls_id).astype(np.uint8)
            num_labels, labels_im = connected_components(class_binary)
            for label_idx in range(1, num_labels):
                current_instance_id = skip_255(current_instance_id)
                instance_map[labels_im == label_idx] = current_instance_id
                id_to_semantic[current_instance_id] = int(cls_id)
                current_instance_id += 1

        return image, instance_map, id_to_semantic, os.path.basename(image_path)
