"""Pre-processed ``.npz`` cache and static-shape batching (numpy only).

Port of ``weed_instance_segmentation_tpu/datasets/dataset_utils.py``: the
same one-``.npz``-per-sample schema and ``_shapes.json`` sidecar, so either
package reads a cache the other wrote, and the same ``ConcatDataset`` and
``Subset``. The JAX package's bit-packed wire format (``processing/wire.py``)
is not ported: a batch travels as the plain ``pad_batch_static`` arrays.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from weed_instance_segmentation_tpu_torch import config

SHAPES_SIDECAR = '_shapes.json'
TRAIN_SAMPLE_KEYS = ('pixel_values', 'mask_labels', 'class_labels')


def _sample_to_npz_dict(item: dict) -> dict:
    ids = sorted(item['id_to_semantic'].keys())
    return {
        'pixel_values': item['pixel_values'].astype(np.float32),
        # binary masks — stored compactly, restored to float32 on load
        'mask_labels': item['mask_labels'].astype(np.uint8),
        'class_labels': item['class_labels'].astype(np.int64),
        'target_size': np.asarray(item['target_size'], dtype=np.int64),
        'original_map': item['original_map'].astype(np.int32),
        'id_keys': np.asarray(ids, dtype=np.int64),
        'id_vals': np.asarray([item['id_to_semantic'][k] for k in ids], dtype=np.int64),
        'file_name': np.asarray(item['file_name']),
    }


def _npz_dict_to_sample(z) -> dict:
    return {
        'pixel_values': z['pixel_values'].astype(np.float32),
        'mask_labels': z['mask_labels'].astype(np.float32),
        'class_labels': z['class_labels'].astype(np.int64),
        'target_size': tuple(int(v) for v in z['target_size']),
        'original_map': z['original_map'],
        'id_to_semantic': {int(k): int(v) for k, v in zip(z['id_keys'], z['id_vals'])},
        'file_name': str(z['file_name']),
    }


class PreprocessedDataset:
    """The ``.npz`` files of ``processed_dir``, in name order. ``keys``
    restricts each item to those raw stored arrays (f32 pixels, uint8 masks,
    int64 classes), as the training loop reads them; ``keys=None`` gives the
    full sample."""

    def __init__(self, processed_dir: str, keys: tuple[str, ...] | None = None):
        self.processed_dir = processed_dir
        self.keys = keys
        self.files = sorted(glob.glob(os.path.join(processed_dir, '*' + config.CACHE_SUFFIX)))
        if not self.files:
            print(f'WARNING: No {config.CACHE_SUFFIX} files found in "{processed_dir}"')

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        with np.load(self.files[idx], allow_pickle=False) as z:
            if self.keys is None:
                return _npz_dict_to_sample(z)
            return {k: z[k] for k in self.keys}


class ConcatDataset:
    """The datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        ds = int(np.searchsorted(self._offsets, idx, side='right')) - 1
        return self.datasets[ds][idx - int(self._offsets[ds])]


class Subset:
    """The items of ``dataset`` at ``indices``, in that order."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[self.indices[idx]]


def collate_fn(batch: list[dict]) -> dict:
    """The reference's ragged collation, as the evaluation path reads it:
    ``pixel_values`` stacked, zero-padded at the bottom and right to the
    batch's largest size; the per-sample label structures kept as lists."""
    shapes = [item['pixel_values'].shape for item in batch]
    max_h = max(s[1] for s in shapes)
    max_w = max(s[2] for s in shapes)
    pixel_values = np.zeros((len(batch), 3, max_h, max_w), dtype=np.float32)
    for k, item in enumerate(batch):
        _, h, w = item['pixel_values'].shape
        pixel_values[k, :, :h, :w] = item['pixel_values']
    return {
        'pixel_values': pixel_values,
        'mask_labels': [item['mask_labels'] for item in batch],
        'class_labels': [item['class_labels'] for item in batch],
        'target_sizes': [item['target_size'] for item in batch],
        'original_maps': [item['original_map'] for item in batch],
        'id_mappings': [item['id_to_semantic'] for item in batch],
        'file_names': [item['file_name'] for item in batch],
    }


def pad_batch_static(batch: list[dict], pad_hw: tuple[int, int],
                     max_instances: int | None = None) -> dict:
    """One static shape for the whole run:

      pixel_values   (B, 3, H, W) float32
      pixel_mask     (B, H, W)    float32   1 = real pixel
      mask_labels    (B, I, H, W) uint8     binary, zero-padded
      class_labels   (B, I)       int32     zero-padded
      instance_valid (B, I)       float32   1 = real instance
      sample_valid   (B,)         float32   1 = real sample
    """
    if max_instances is None:
        max_instances = config.MAX_INSTANCES
    ph, pw = pad_hw
    b = len(batch)
    pixel_values = np.zeros((b, 3, ph, pw), dtype=np.float32)
    pixel_mask = np.zeros((b, ph, pw), dtype=np.float32)
    mask_labels = np.zeros((b, max_instances, ph, pw), dtype=np.uint8)
    class_labels = np.zeros((b, max_instances), dtype=np.int32)
    instance_valid = np.zeros((b, max_instances), dtype=np.float32)

    for k, item in enumerate(batch):
        _, h, w = item['pixel_values'].shape
        if h > ph or w > pw:
            raise ValueError(f'sample {k} ({h}x{w}) exceeds static pad size {pad_hw}')
        pixel_values[k, :, :h, :w] = item['pixel_values']
        pixel_mask[k, :h, :w] = 1.0
        n = min(item['mask_labels'].shape[0], max_instances)
        if item['mask_labels'].shape[0] > max_instances:
            print(f'WARNING: sample has {item["mask_labels"].shape[0]} instances, '
                  f'truncating to MAX_INSTANCES={max_instances}')
        if n > 0:
            mh, mw = item['mask_labels'].shape[1:]
            mask_labels[k, :n, :mh, :mw] = item['mask_labels'][:n]
            class_labels[k, :n] = item['class_labels'][:n]
            instance_valid[k, :n] = 1.0
    return {
        'pixel_values': pixel_values,
        'pixel_mask': pixel_mask,
        'mask_labels': mask_labels,
        'class_labels': class_labels,
        'instance_valid': instance_valid,
        'sample_valid': np.ones((b,), dtype=np.float32),
    }


def make_train_collate(pad_hw: tuple[int, int], max_instances: int, batch_rows: int):
    """Collate ``TRAIN_SAMPLE_KEYS`` samples into the static batch of
    :func:`pad_batch_static`. A short batch is padded to ``batch_rows`` with
    repeats of its last sample, zeroed in ``sample_valid`` and
    ``instance_valid`` so they add nothing to the loss."""

    def collate(samples: list[dict]) -> dict:
        n = len(samples)
        out = pad_batch_static(list(samples) + [samples[-1]] * (batch_rows - n), pad_hw,
                               max_instances)
        out['sample_valid'][n:] = 0.0
        out['instance_valid'][n:] = 0.0
        return out

    return collate


def process_and_save(dataset, output_dir: str) -> None:
    """Write every sample of ``dataset`` to ``output_dir`` as one ``.npz``
    per image, plus the ``_shapes.json`` sidecar of (H, W, instances)."""
    os.makedirs(output_dir, exist_ok=True)
    print(f'\t\tSaving to "{output_dir}"')
    total = len(dataset)
    shapes = {}
    for i in range(total):
        item = dataset[i]
        base_name = os.path.splitext(item['file_name'])[0]
        with open(os.path.join(output_dir, base_name + config.CACHE_SUFFIX), 'wb') as f:
            np.savez(f, **_sample_to_npz_dict(item))
        shapes[base_name] = [int(item['pixel_values'].shape[1]),
                             int(item['pixel_values'].shape[2]),
                             int(item['mask_labels'].shape[0])]
    with open(os.path.join(output_dir, SHAPES_SIDECAR), 'w') as f:
        json.dump(shapes, f)
    print(f'\t\tProcessed {total}/{total} images')


def compute_static_pad_hw(processed_dirs: list[str],
                          multiple: int | None = None) -> tuple[tuple[int, int], int]:
    """((max H, max W) rounded up to ``multiple``, max instance count) over
    the given caches, from their sidecars (or their arrays where a cache has
    no sidecar)."""
    multiple = multiple or config.PAD_TO_MULTIPLE
    max_h = max_w = max_i = 1
    for d in processed_dirs:
        sidecar = os.path.join(d, SHAPES_SIDECAR)
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                shapes = json.load(f)
            for h, w, n in shapes.values():
                max_h, max_w, max_i = max(max_h, h), max(max_w, w), max(max_i, n)
        else:
            ds = PreprocessedDataset(d)
            for k in range(len(ds)):
                item = ds[k]
                _, h, w = item['pixel_values'].shape
                max_h, max_w = max(max_h, h), max(max_w, w)
                max_i = max(max_i, item['mask_labels'].shape[0])

    def ceil_to(v):
        return int(-(-v // multiple) * multiple)

    return (ceil_to(max_h), ceil_to(max_w)), max_i
