"""crop_weed (CWFID) reader: YAML polygon annotations.

Port of ``weed_instance_segmentation_tpu/datasets/crop_weed/
annotation_dependent_implementations/dataset_from_yaml_annotations.py``:
every ``*.yaml`` file whose ``filename`` names an existing image; polygons
from ``annotation[].points.{x,y}``, a lone float point promoted to a
one-point list, regions with fewer than 3 points or unequal x/y lengths
skipped, unknown type names skipped. ``yaml`` is imported by the functions
that read a file, so the module imports without it.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from weed_instance_segmentation_tpu_torch.datasets.base import (
    IGNORE_INDEX, WeedInstanceDataset, open_rgb, skip_255, truncate_to_max_images,
)
from weed_instance_segmentation_tpu_torch.ops.rasterize import fill_poly


def read_yaml(path: str):
    """The YAML document at ``path`` (``yaml.safe_load``)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


class CropWeedDataset(WeedInstanceDataset):
    def __init__(self, image_folder_path=None, annotation_path=None, processor=None,
                 label2id=None, **kwargs):
        super().__init__(image_folder_path, annotation_path, processor, label2id, **kwargs)
        yaml_files = sorted(glob.glob(os.path.join(self.annotation_path, '*.yaml')))
        print(f'Scanning {len(yaml_files)} annotation files in "{self.annotation_path}"...')

        valid = []
        for yaml_path in yaml_files:
            try:
                data = read_yaml(yaml_path)
                if not data:
                    continue
                img_filename = data.get('filename')
                if not img_filename:
                    continue
                img_path = os.path.join(self.image_folder, img_filename)
                if os.path.exists(img_path):
                    valid.append((img_path, yaml_path))
            except ImportError:
                raise
            except Exception as e:
                print(f'Warning: Error reading "{yaml_path}":\n\t {e}')
        self.valid_files = truncate_to_max_images(valid)
        print(f'\tLoaded {len(self.valid_files)} valid image/yaml pairs from "{self.image_folder}"')

    def _entries(self):
        return self.valid_files

    def _load_sample(self, idx: int):
        image_path, yaml_path = self.valid_files[idx]
        image = open_rgb(image_path)
        annotation_data = read_yaml(yaml_path)

        image, scale_factor = self._resize_to_max_dim(image)
        width, height = image.size

        instance_map = np.full((height, width), IGNORE_INDEX, dtype=np.int32)
        id_to_semantic: dict[int, int] = {}
        current_instance_id = 1

        regions = annotation_data.get('annotation', []) or []
        for region in regions:
            type_name = region.get('type')
            if type_name not in self.label2id:
                continue
            class_id = self.label2id[type_name]
            current_instance_id = skip_255(current_instance_id)

            points_dict = region.get('points', {})
            xs = points_dict.get('x', [])
            ys = points_dict.get('y', [])
            if not isinstance(xs, list) or not isinstance(ys, list):
                if isinstance(xs, float) and isinstance(ys, float):
                    xs, ys = [xs], [ys]
                else:
                    print('skipping region with invalid points format (not lists)')
                    print(f'xs: {xs}\n ys: {ys}')
                    continue
            if len(xs) != len(ys) or len(xs) < 3:
                continue

            points = np.array(
                [[int(x * scale_factor), int(y * scale_factor)] for x, y in zip(xs, ys)],
                dtype=np.int32,
            )
            fill_poly(instance_map, points, current_instance_id)
            id_to_semantic[current_instance_id] = class_id
            current_instance_id += 1

        return image, instance_map, id_to_semantic, os.path.basename(image_path)
