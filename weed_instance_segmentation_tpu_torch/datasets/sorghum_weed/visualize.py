"""sorghum_weed ground-truth viewer: each image with its VGG-JSON polygons
drawn over it.

Port of ``weed_instance_segmentation_tpu/datasets/sorghum_weed/visualize.py``;
PIL is imported when an image is read.
"""

from __future__ import annotations

import json
import os

from weed_instance_segmentation_tpu_torch.datasets.sorghum_weed import definitions
from weed_instance_segmentation_tpu_torch.datasets.visualize_utils import (
    iter_limited, overlay_polygons, show_or_save,
)

CLASS_COLORS = {'Sorghum': 'lime', 'BLweed': 'red', 'Grass': 'blue', 'default': 'yellow'}


def visualize_dataset(image_folder: str, annotation_file: str, show: bool = True) -> int:
    if not os.path.exists(annotation_file):
        print(f'Error: Annotation file not found at {annotation_file}')
        return 0

    from PIL import Image

    print('Loading annotations...')
    with open(annotation_file) as f:
        data = json.load(f)

    count = 0
    for entry in iter_limited(data.values()):
        file_name = entry['filename']
        image_path = os.path.join(image_folder, file_name)
        if not os.path.exists(image_path):
            continue
        print(f'Displaying: {file_name}')
        image = Image.open(image_path)
        polygons = []
        for region in entry.get('regions', []):
            shape_attr = region['shape_attributes']
            if shape_attr['name'] != 'polygon':
                continue
            class_name = region['region_attributes'].get('classname', 'default')
            points = list(zip(shape_attr['all_points_x'], shape_attr['all_points_y']))
            polygons.append((points, class_name, CLASS_COLORS.get(class_name, 'yellow')))
        fig = overlay_polygons(image, polygons, title=f'Ground Truth: {file_name}')
        show_or_save(fig, file_name, show)
        count += 1
    return count


if __name__ == '__main__':
    visualize_dataset(definitions.TRAIN_IMG_DIR, definitions.TRAIN_ANNOTATIONS)
