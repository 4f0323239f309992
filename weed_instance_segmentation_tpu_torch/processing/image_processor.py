"""Mask2Former image pre-processing on the host (numpy), the cache writer's.

Port of ``weed_instance_segmentation_tpu/processing/image_processor.py``,
which reimplements the HF slow processor (``transformers==4.57.6``
``image_processing_mask2former.py``) so the ``.npz`` cache holds the bits the
reference pipeline gives:

    resize shortest/longest edge with aspect ratio, ceil to size_divisor
    (HF:347-391,445-484) -> rescale 1/255 in float64 + ImageNet normalize
    (HF:602-624) -> batch pad bottom/right + pixel_mask (HF:809-899) ->
    segmentation map -> binary mask stack + class labels (HF:305-340), mask
    pad constant = ignore_index (HF:988-992).

An image is an HWC (or CHW, or 2-D) array, or anything ``np.asarray`` reads
as one, a PIL image included; the module imports without PIL, which only
the resizes (``ops/resize.py``) import when they run. ``return_tensors`` is
'np' or 'pt'.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from weed_instance_segmentation_tpu_torch.ops.resize import pil_resize_image, pil_resize_mask

IMAGENET_DEFAULT_MEAN = [0.485, 0.456, 0.406]
IMAGENET_DEFAULT_STD = [0.229, 0.224, 0.225]

PROCESSOR_CONFIG_NAME = 'preprocessor_config.json'


def get_size_with_aspect_ratio(image_size, size, max_size=None) -> tuple[int, int]:
    """Shortest-edge/longest-edge aspect-preserving output size (HF:64-101)."""
    height, width = image_size
    raw_size = None
    if max_size is not None:
        min_original_size = float(min((height, width)))
        max_original_size = float(max((height, width)))
        if max_original_size / min_original_size * size > max_size:
            raw_size = max_size * min_original_size / max_original_size
            size = int(round(raw_size))

    if (height <= width and height == size) or (width <= height and width == size):
        return (height, width)
    if width < height:
        ow = size
        oh = int(raw_size * height / width) if raw_size is not None else int(size * height / width)
    else:
        oh = size
        ow = int(raw_size * width / height) if raw_size is not None else int(size * width / height)
    return (oh, ow)


def compute_output_size(
    input_hw: tuple[int, int],
    shortest_edge: int,
    longest_edge: int | None,
    size_divisor: int,
) -> tuple[int, int]:
    """Resize geometry incl. ceil-to-divisor (HF:347-391)."""
    oh, ow = get_size_with_aspect_ratio(input_hw, shortest_edge, longest_edge)
    if size_divisor > 0:
        oh = int(math.ceil(oh / size_divisor) * size_divisor)
        ow = int(math.ceil(ow / size_divisor) * size_divisor)
    return (oh, ow)


def convert_segmentation_map_to_binary_masks(
    segmentation_map: np.ndarray,
    instance_id_to_semantic_id: dict[int, int] | None = None,
    ignore_index: int | None = None,
    do_reduce_labels: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Unique ids (minus ignore) → float32 binary mask stack + int64 labels
    (HF:305-340)."""
    if do_reduce_labels:
        if ignore_index is None:
            raise ValueError('If `do_reduce_labels` is True, `ignore_index` must be provided.')
        segmentation_map = np.where(segmentation_map == 0, ignore_index, segmentation_map - 1)

    all_labels = np.unique(segmentation_map)
    if ignore_index is not None:
        all_labels = all_labels[all_labels != ignore_index]

    if len(all_labels):
        binary_masks = np.stack([(segmentation_map == i) for i in all_labels], axis=0)
    else:
        binary_masks = np.zeros((0, *segmentation_map.shape))

    if instance_id_to_semantic_id is not None:
        labels = np.zeros(all_labels.shape[0])
        for label in all_labels:
            class_id = instance_id_to_semantic_id[label + 1 if do_reduce_labels else label]
            labels[all_labels == label] = class_id - 1 if do_reduce_labels else class_id
    else:
        labels = all_labels

    return binary_masks.astype(np.float32), labels.astype(np.int64)


def _infer_hw(image: np.ndarray) -> tuple[int, int]:
    """Height/width of an HWC or CHW or 2D array (channels ∈ {1,3,4})."""
    if image.ndim == 2:
        return image.shape
    if image.shape[0] in (1, 3, 4) and image.shape[-1] not in (1, 3, 4):
        return image.shape[1], image.shape[2]  # CHW
    return image.shape[0], image.shape[1]  # HWC


class Mask2FormerImageProcessor:
    """Twin of HF ``Mask2FormerImageProcessor`` returning numpy (or torch)
    arrays. The dataset readers call it once a sample with its instance map
    and ``ignore_index=255``."""

    def __init__(
        self,
        do_resize: bool = True,
        size: dict | None = None,
        size_divisor: int = 32,
        resample=None,  # accepted for config compat; bilinear is implied
        do_rescale: bool = True,
        rescale_factor: float = 1 / 255,
        do_normalize: bool = True,
        image_mean=None,
        image_std=None,
        ignore_index: int | None = None,
        do_reduce_labels: bool = False,
        num_labels: int | None = None,
        pad_size: dict | None = None,
        **kwargs,
    ):
        self._max_size = kwargs.pop('max_size', 1333)
        if size is None:
            size = {'shortest_edge': 800, 'longest_edge': self._max_size}
        self.do_resize = do_resize
        self.size = dict(size)
        self.size_divisor = size_divisor
        self.do_rescale = do_rescale
        self.rescale_factor = rescale_factor
        self.do_normalize = do_normalize
        self.image_mean = list(image_mean) if image_mean is not None else list(IMAGENET_DEFAULT_MEAN)
        self.image_std = list(image_std) if image_std is not None else list(IMAGENET_DEFAULT_STD)
        self.ignore_index = ignore_index
        self.do_reduce_labels = do_reduce_labels
        self.num_labels = num_labels
        self.pad_size = pad_size

    # -- config I/O -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            'image_processor_type': 'Mask2FormerImageProcessor',
            'do_resize': self.do_resize,
            'size': self.size,
            'size_divisor': self.size_divisor,
            'do_rescale': self.do_rescale,
            'rescale_factor': self.rescale_factor,
            'do_normalize': self.do_normalize,
            'image_mean': self.image_mean,
            'image_std': self.image_std,
            'ignore_index': self.ignore_index,
            'do_reduce_labels': self.do_reduce_labels,
            'num_labels': self.num_labels,
            'pad_size': self.pad_size,
        }

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> 'Mask2FormerImageProcessor':
        """Load from a directory containing ``preprocessor_config.json``
        (HF checkpoint layout)."""
        cfg_file = path if path.endswith('.json') else os.path.join(path, PROCESSOR_CONFIG_NAME)
        with open(cfg_file) as f:
            cfg = json.load(f)
        cfg.pop('image_processor_type', None)
        cfg.pop('feature_extractor_type', None)
        cfg.pop('resample', None)
        cfg.update(kwargs)
        return cls(**cfg)

    def save_pretrained(self, save_directory: str) -> None:
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, PROCESSOR_CONFIG_NAME), 'w') as f:
            json.dump(self.to_dict(), f, indent=2)

    # -- geometry ----------------------------------------------------------

    def output_size_for(self, input_hw: tuple[int, int]) -> tuple[int, int]:
        if not self.do_resize:
            return input_hw
        if 'shortest_edge' in self.size:
            return compute_output_size(
                input_hw, self.size['shortest_edge'], self.size.get('longest_edge'), self.size_divisor
            )
        return compute_output_size(
            input_hw, min(self.size['height'], self.size['width']), None, self.size_divisor
        )

    # -- per-image transforms ----------------------------------------------

    def _resize_image(self, image: np.ndarray) -> np.ndarray:
        out_hw = self.output_size_for(_infer_hw(image))
        if out_hw == _infer_hw(image):
            return image
        return pil_resize_image(image, out_hw)

    def _resize_mask(self, mask: np.ndarray) -> np.ndarray:
        out_hw = self.output_size_for(mask.shape)
        if out_hw == mask.shape:
            return mask
        return pil_resize_mask(mask, out_hw)

    def _rescale_normalize(self, image: np.ndarray) -> np.ndarray:
        # HF rescales in float64 then casts (image_transforms.rescale) — match
        # the exact rounding.
        if self.do_rescale:
            image = (image.astype(np.float64) * self.rescale_factor).astype(np.float32)
        image = image.astype(np.float32)
        if self.do_normalize:
            mean = np.asarray(self.image_mean, dtype=np.float32)
            std = np.asarray(self.image_std, dtype=np.float32)
            image = (image - mean) / std
        return image

    # -- main entry ---------------------------------------------------------

    def __call__(self, images, segmentation_maps=None, **kwargs):
        return self.preprocess(images, segmentation_maps=segmentation_maps, **kwargs)

    def preprocess(
        self,
        images,
        segmentation_maps=None,
        instance_id_to_semantic_id=None,
        ignore_index: int | None = None,
        do_reduce_labels: bool | None = None,
        return_tensors: str = 'np',
        pad_size: dict | None = None,
        **kwargs,
    ) -> dict:
        ignore_index = self.ignore_index if ignore_index is None else ignore_index
        do_reduce_labels = self.do_reduce_labels if do_reduce_labels is None else do_reduce_labels

        if not isinstance(images, (list, tuple)):
            images = [images]
        images = [np.asarray(im) for im in images]
        if segmentation_maps is not None and not isinstance(segmentation_maps, (list, tuple)):
            segmentation_maps = [segmentation_maps]

        processed = []
        for im in images:
            if self.do_resize:
                im = self._resize_image(im)
            processed.append(self._rescale_normalize(im))  # HWC float32

        # Pad to batch max (or explicit pad_size) — bottom/right, zeros.
        pad_size = pad_size if pad_size is not None else self.pad_size
        sizes = [p.shape[:2] for p in processed]
        if pad_size is not None:
            pad_h, pad_w = pad_size['height'], pad_size['width']
        else:
            pad_h = max(s[0] for s in sizes)
            pad_w = max(s[1] for s in sizes)

        pixel_values = np.zeros((len(processed), 3, pad_h, pad_w), dtype=np.float32)
        pixel_mask = np.zeros((len(processed), pad_h, pad_w), dtype=np.int64)
        for k, p in enumerate(processed):
            h, w = p.shape[:2]
            pixel_values[k, :, :h, :w] = p.transpose(2, 0, 1)
            pixel_mask[k, :h, :w] = 1

        data = {'pixel_values': pixel_values, 'pixel_mask': pixel_mask}

        if segmentation_maps is not None:
            # Binary-mask conversion pads to the *unpadded* batch max
            # (HF:980 uses pre-pad sizes; with per-sample processing this is
            # a no-op, matching the reference cache — SURVEY.md §2.5.4).
            seg_pad_hw = (max(s[0] for s in sizes), max(s[1] for s in sizes))
            mask_labels, class_labels = [], []
            for idx, seg in enumerate(segmentation_maps):
                seg = np.asarray(seg)
                if self.do_resize:
                    seg = self._resize_mask(seg)
                mapping = (
                    instance_id_to_semantic_id[idx]
                    if isinstance(instance_id_to_semantic_id, list)
                    else instance_id_to_semantic_id
                )
                masks, classes = convert_segmentation_map_to_binary_masks(
                    seg, mapping, ignore_index=ignore_index, do_reduce_labels=do_reduce_labels
                )
                if masks.shape[0] > 0:
                    mh, mw = masks.shape[1:]
                    padded = np.full(
                        (masks.shape[0], *seg_pad_hw),
                        0 if ignore_index is None else ignore_index,
                        dtype=np.float32,
                    )
                    padded[:, :mh, :mw] = masks
                    masks = padded
                else:
                    masks = np.zeros((0, *seg_pad_hw), dtype=np.float32)
                mask_labels.append(masks)
                class_labels.append(classes)
            data['mask_labels'] = mask_labels
            data['class_labels'] = class_labels

        return _convert_tensors(data, return_tensors)


def _convert_tensors(data: dict, return_tensors: str) -> dict:
    if return_tensors in ('np', None):
        return data
    if return_tensors == 'pt':
        import torch

        return {
            k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else [torch.from_numpy(x) for x in v])
            for k, v in data.items()
        }
    raise ValueError(f'Unsupported return_tensors={return_tensors!r} (np/pt)')
