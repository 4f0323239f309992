"""Shared machinery of the raw (un-cached) dataset readers.

Port of ``weed_instance_segmentation_tpu/datasets/base.py``. Every reader
gives the reference's 7-key sample dict (pixel_values, mask_labels,
class_labels, target_size, original_map, id_to_semantic, file_name) of numpy
arrays. The readers differ only in how they turn annotations into an
``(instance_map, instance_id_to_semantic_id)`` pair; the resize, the
processor call and the packaging live here.

PIL is imported only where an image is decoded or resized
(:func:`open_rgb`, ``_resize_to_max_dim``), so the module imports without
it; reading raw data needs it, and raises ``ImportError`` there without it.
"""

from __future__ import annotations

import numpy as np

from weed_instance_segmentation_tpu_torch import config

IGNORE_INDEX = 255


class WeedInstanceDataset:
    """Base class: a sequence of 7-key sample dicts."""

    def __init__(self, image_folder_path=None, annotation_path=None, processor=None,
                 label2id: dict | None = None, **kwargs):
        # the reference's callers spell the annotation argument two ways
        # (annotation_path, annotation_file_path); both are accepted
        if annotation_path is None:
            annotation_path = kwargs.pop('annotation_file_path', None)
        else:
            kwargs.pop('annotation_file_path', None)
        if kwargs:
            raise TypeError(f'Unexpected kwargs: {sorted(kwargs)}')
        self.image_folder = image_folder_path
        self.annotation_path = annotation_path
        self.processor = processor
        self.label2id = label2id or {}

    def _entries(self):
        """The per-sample descriptors (set in a subclass's __init__)."""
        raise NotImplementedError

    def _load_sample(self, idx: int):
        """(PIL RGB image, int32 H x W instance map, id_to_semantic,
        file_name); the map at the (resized-to-MAX_INPUT_DIM) image's size,
        background/ignore 255."""
        raise NotImplementedError

    @staticmethod
    def _resize_to_max_dim(image):
        """Long-side bilinear resize of a PIL image to config.MAX_INPUT_DIM,
        as every reference reader does before the processor; returns
        (image, scale factor)."""
        from PIL import Image

        width, height = image.size
        scale_factor = 1.0
        if max(width, height) > config.MAX_INPUT_DIM:
            scale_factor = config.MAX_INPUT_DIM / max(width, height)
            new_width = int(width * scale_factor)
            new_height = int(height * scale_factor)
            image = image.resize(size=(new_width, new_height), resample=Image.BILINEAR)
        return image, scale_factor

    def __len__(self) -> int:
        return len(self._entries())

    def __getitem__(self, idx: int) -> dict:
        image, instance_map, id_to_semantic, file_name = self._load_sample(idx)
        width, height = image.size
        inputs = self.processor(
            images=[image],
            segmentation_maps=[instance_map],
            instance_id_to_semantic_id=id_to_semantic,
            return_tensors='np',
            ignore_index=IGNORE_INDEX,
        )
        return {
            'pixel_values': inputs['pixel_values'][0],
            'mask_labels': inputs['mask_labels'][0],
            'class_labels': inputs['class_labels'][0],
            'target_size': (height, width),
            'original_map': instance_map,
            'id_to_semantic': id_to_semantic,
            'file_name': file_name,
        }


def truncate_to_max_images(items: list) -> list:
    """The first config.MAX_IMAGES items, as every reference reader keeps."""
    if config.MAX_IMAGES is not None:
        return items[: config.MAX_IMAGES]
    return items


def open_rgb(path: str):
    """The image at ``path`` as a PIL RGB image."""
    from PIL import Image

    return Image.open(path).convert('RGB')


def read_image_array(path: str, mode: str | None = None) -> np.ndarray:
    """The image at ``path`` as an array at its own bit depth (16-bit PNG
    masks stay 16-bit), converted to ``mode`` first if one is given."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im if mode is None else im.convert(mode))


def skip_255(current_instance_id: int) -> int:
    """Instance id 255 is the ignore index; every reference reader skips it
    when numbering instances."""
    return current_instance_id + 1 if current_instance_id == IGNORE_INDEX else current_instance_id
