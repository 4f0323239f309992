"""crop_weed ground-truth viewer for YAML annotations: each image with its
instance polygons drawn over it.

Port of ``weed_instance_segmentation_tpu/datasets/crop_weed/
annotation_dependent_implementations/visualize_yaml_annotations.py``; PIL
and yaml are imported when the annotations and images are read.
"""

from __future__ import annotations

import glob
import os

from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions
from weed_instance_segmentation_tpu_torch.datasets.visualize_utils import (
    iter_limited, overlay_polygons, show_or_save,
)

CLASS_COLORS = {'crop': 'lime', 'weed': 'red'}


def visualize_dataset(image_folder: str | None = None,
                      annotation_folder: str | None = None,
                      show: bool = True) -> int:
    import yaml
    from PIL import Image

    image_folder = image_folder or definitions.IMG_DIR
    annotation_folder = annotation_folder or definitions.ANNOTATIONS
    if not os.path.exists(annotation_folder):
        print(f'Error: Annotation folder not found at {annotation_folder}')
        return 0

    yaml_files = sorted(glob.glob(os.path.join(annotation_folder, '*.yaml')))
    count = 0
    for yaml_path in iter_limited(yaml_files):
        try:
            with open(yaml_path) as f:
                data = yaml.safe_load(f)
        except Exception as e:
            print(f'Warning: failed to parse {yaml_path}: {e}')
            continue
        file_name = data.get('filename')
        if not file_name:
            continue
        img_path = os.path.join(image_folder, file_name)
        if not os.path.exists(img_path):
            continue
        print(f'Displaying: {file_name}')
        image = Image.open(img_path)
        polygons = []
        for ann in data.get('annotation', []) or []:
            cls = ann.get('type')
            pts = ann.get('points', {})
            xs, ys = pts.get('x'), pts.get('y')
            if xs is None or ys is None:
                continue
            if isinstance(xs, float):
                xs = [xs]
            if isinstance(ys, float):
                ys = [ys]
            if len(xs) != len(ys) or len(xs) < 3:
                continue
            polygons.append(
                (list(zip(xs, ys)), cls, CLASS_COLORS.get(cls, 'yellow'))
            )
        fig = overlay_polygons(image, polygons, title=f'Ground Truth: {file_name}')
        show_or_save(fig, file_name, show)
        count += 1
    return count


if __name__ == '__main__':
    visualize_dataset()
