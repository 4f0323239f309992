"""crop_weed (CWFID) reader: RGB PNG semantic annotations.

Port of ``weed_instance_segmentation_tpu/datasets/crop_weed/
annotation_dependent_implementations/dataset_from_png_annotations.py``:
``NNN_image.png`` paired with ``NNN_annotation.png``; exact RGB colour match,
green (0, 255, 0) crop and red (255, 0, 0) weed; each class's connected
components are its instances.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from weed_instance_segmentation_tpu_torch.datasets.base import (
    IGNORE_INDEX, WeedInstanceDataset, open_rgb, read_image_array, skip_255,
    truncate_to_max_images,
)
from weed_instance_segmentation_tpu_torch.ops.rasterize import color_match, connected_components
from weed_instance_segmentation_tpu_torch.ops.resize import pil_resize_mask


class CropWeedDataset(WeedInstanceDataset):
    def __init__(self, image_folder_path=None, annotation_path=None, processor=None,
                 label2id=None, **kwargs):
        super().__init__(image_folder_path, annotation_path, processor, label2id, **kwargs)
        image_files = sorted(glob.glob(os.path.join(self.image_folder, '*.png')))

        valid = []
        for img_path in image_files:
            base_name = os.path.splitext(os.path.basename(img_path))[0]
            image_number = base_name.split('_')[0]
            mask_path = os.path.join(self.annotation_path, image_number + '_annotation.png')
            if os.path.exists(mask_path):
                valid.append((img_path, mask_path))
        self.valid_files = truncate_to_max_images(valid)
        print(f'\tLoaded {len(self.valid_files)} valid image/mask pairs from "{self.image_folder}"')

    def _entries(self):
        return self.valid_files

    def _load_sample(self, idx: int):
        image_path, mask_path = self.valid_files[idx]
        image = open_rgb(image_path)
        mask_rgb = read_image_array(mask_path, 'RGB')

        image, _ = self._resize_to_max_dim(image)
        width, height = image.size
        if mask_rgb.shape[:2] != (height, width):
            # nearest-resize each channel, so the colour codes stay exact
            mask_rgb = np.stack(
                [pil_resize_mask(mask_rgb[..., c], (height, width)) for c in range(3)],
                axis=-1,
            ).astype(np.uint8)

        instance_map = np.full((height, width), IGNORE_INDEX, dtype=np.int32)
        id_to_semantic: dict[int, int] = {}
        current_instance_id = 1

        color_map = {
            'crop': {'color': (0, 255, 0), 'id': self.label2id.get('crop', 0)},
            'weed': {'color': (255, 0, 0), 'id': self.label2id.get('weed', 1)},
        }
        for cls_info in color_map.values():
            class_mask = color_match(mask_rgb, cls_info['color'])
            num_labels, labels_im = connected_components(class_mask)
            for label_idx in range(1, num_labels):
                current_instance_id = skip_255(current_instance_id)
                instance_map[labels_im == label_idx] = current_instance_id
                id_to_semantic[current_instance_id] = cls_info['id']
                current_instance_id += 1

        return image, instance_map, id_to_semantic, os.path.basename(image_path)
