"""sorghum_weed reader: VGG-style JSON polygon annotations.

Port of ``weed_instance_segmentation_tpu/datasets/sorghum_weed/dataset.py``:
entries from one JSON file, kept where the image exists and has at least one
region; long-side resize to MAX_INPUT_DIM with the polygon coordinates
scaled; each polygon filled as one instance (id 255 skipped); non-polygon
shapes and unknown class names skipped.
"""

from __future__ import annotations

import json
import os

import numpy as np

from weed_instance_segmentation_tpu_torch.datasets.base import (
    IGNORE_INDEX, WeedInstanceDataset, open_rgb, skip_255, truncate_to_max_images,
)
from weed_instance_segmentation_tpu_torch.ops.rasterize import fill_poly


class SorghumWeedDataset(WeedInstanceDataset):
    def __init__(self, image_folder_path=None, annotation_path=None, processor=None,
                 label2id=None, **kwargs):
        super().__init__(image_folder_path, annotation_path, processor, label2id, **kwargs)
        with open(self.annotation_path) as f:
            data = list(json.load(f).values())

        valid = []
        for entry in data:
            img_path = os.path.join(self.image_folder, entry['filename'])
            if os.path.exists(img_path) and len(entry.get('regions', [])) > 0:
                valid.append(entry)
        self.valid_entries = truncate_to_max_images(valid)
        print(f'\t\tLoaded {len(self.valid_entries)} valid images from "{self.annotation_path}"')

    def _entries(self):
        return self.valid_entries

    def _load_sample(self, idx: int):
        entry = self.valid_entries[idx]
        image = open_rgb(os.path.join(self.image_folder, entry['filename']))
        image, scale_factor = self._resize_to_max_dim(image)
        width, height = image.size

        instance_map = np.full((height, width), IGNORE_INDEX, dtype=np.int32)
        id_to_semantic: dict[int, int] = {}
        current_instance_id = 1

        for region in entry.get('regions', []):
            shape_attr = region['shape_attributes']
            region_attr = region['region_attributes']
            if shape_attr['name'] != 'polygon':
                continue
            class_name = region_attr.get('classname', None)
            if class_name not in self.label2id:
                continue
            class_id = self.label2id[class_name]
            current_instance_id = skip_255(current_instance_id)

            all_x = [int(x * scale_factor) for x in shape_attr['all_points_x']]
            all_y = [int(y * scale_factor) for y in shape_attr['all_points_y']]
            points = np.array(list(zip(all_x, all_y)), dtype=np.int32)
            fill_poly(instance_map, points, current_instance_id)

            id_to_semantic[current_instance_id] = class_id
            current_instance_id += 1

        return image, instance_map, id_to_semantic, entry['filename']
