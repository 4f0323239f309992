"""Write each dataset's splits into the ``.npz`` cache.

    python -m weed_instance_segmentation_tpu_torch.datasets.preprocess

Port of ``weed_instance_segmentation_tpu/datasets/preprocess.py``, and it
writes the same files: per dataset of ``config.DATASET_LIST``, an optional
FORCE_PREPROCESSING clean-up; ``PROCESSED_DIR`` created with
``exist_ok=False`` as the already-done mark; a seeded split where the
definitions carry TRAIN_VAL_TEST_SPLIT (crop_weed), else the predefined
Train/Validate/Test folders. The rounding remainder goes to the last nonzero
split, so the splits always sum to the dataset's size.

It reads raw images, so it needs PIL: run it where PIL is installed, and
train on the card from the cache it writes.
"""

from __future__ import annotations

import os
import shutil

import torch

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import Subset, process_and_save
from weed_instance_segmentation_tpu_torch.datasets.factory import get_dataset_and_config
from weed_instance_segmentation_tpu_torch.processing.image_processor import (
    Mask2FormerImageProcessor,
)


def split_lengths(total_size: int, ratios: list[float]) -> list[int]:
    """Integer split lengths; the remainder goes to the last nonzero split."""
    lengths = [int(r * total_size) for r in ratios]
    remainder = total_size - sum(lengths)
    if remainder:
        last_nonzero = max(i for i, r in enumerate(ratios) if r > 0)
        lengths[last_nonzero] += remainder
    return lengths


def seeded_permutation(n: int, seed: int = 42) -> list[int]:
    """``torch.random_split``'s permutation with a generator seeded 42, as
    the reference draws it."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()


def build_processor() -> Mask2FormerImageProcessor:
    """The processor of ``config.MODEL_CHECKPOINT`` where it is a local
    directory holding one, else the Mask2Former COCO defaults."""
    ckpt = config.MODEL_CHECKPOINT
    if os.path.isdir(ckpt) and os.path.exists(os.path.join(ckpt, 'preprocessor_config.json')):
        return Mask2FormerImageProcessor.from_pretrained(ckpt)
    return Mask2FormerImageProcessor()


def preprocess_dataset(dataset_name: str, processor, label2id: dict | None = None,
                       force: bool | None = None) -> bool:
    """Write one dataset's splits. Returns True if work was done, False if
    its ``PROCESSED_DIR`` already existed. ``label2id`` overrides the
    dataset's own map (the trainer passes the unified one)."""
    WeedDataset, ds_config = get_dataset_and_config(dataset_name)
    force = config.FORCE_PREPROCESSING if force is None else force

    if force and os.path.exists(ds_config.PROCESSED_DIR):
        print(f'\tForce Preprocessing: Cleaning {ds_config.PROCESSED_DIR}...')
        shutil.rmtree(ds_config.PROCESSED_DIR)

    try:
        os.makedirs(ds_config.PROCESSED_DIR, exist_ok=False)
    except OSError:
        print(f'\tDataset "{dataset_name}" already preprocessed, skipping...\n')
        return False

    label2id = label2id if label2id is not None else ds_config.LABEL2ID
    if hasattr(ds_config, 'TRAIN_VAL_TEST_SPLIT'):
        ratios = ds_config.TRAIN_VAL_TEST_SPLIT
        print(f'\tNo predefined split found. Splitting dataset with ratios {ratios}...')
        full_ds = WeedDataset(
            image_folder_path=ds_config.IMG_DIR,
            annotation_path=ds_config.ANNOTATIONS,
            processor=processor,
            label2id=label2id,
        )
        lengths = split_lengths(len(full_ds), ratios)
        print(f'\tSplit sizes: Train={lengths[0]}, Val={lengths[1]}, Test={lengths[2]}')

        perm = seeded_permutation(len(full_ds))
        offsets = [0, lengths[0], lengths[0] + lengths[1], sum(lengths)]
        for i, name in enumerate(('Train', 'Validate', 'Test')):
            if lengths[i] > 0:
                subset = Subset(full_ds, perm[offsets[i]:offsets[i + 1]])
                process_and_save(subset, output_dir=os.path.join(ds_config.PROCESSED_DIR, name))
    else:
        print(f'\tUsing predefined splits from {dataset_name} definitions.')
        for name, img_dir, ann in (
            ('Train', ds_config.TRAIN_IMG_DIR, ds_config.TRAIN_ANNOTATIONS),
            ('Validate', ds_config.VAL_IMG_DIR, ds_config.VAL_ANNOTATIONS),
            ('Test', ds_config.TEST_IMG_DIR, ds_config.TEST_ANNOTATIONS),
        ):
            ds = WeedDataset(
                image_folder_path=img_dir,
                annotation_path=ann,
                processor=processor,
                label2id=label2id,
            )
            process_and_save(ds, output_dir=os.path.join(ds_config.PROCESSED_DIR, name))
    return True


def main() -> None:
    processor = build_processor()
    for dataset_name in config.DATASET_LIST:
        print(f'=== Processing Dataset: {dataset_name} ===')
        if preprocess_dataset(dataset_name, processor):
            print(f'\tFinished processing {dataset_name}\n')
    print('--- Processing Complete ---\n')


if __name__ == '__main__':
    main()
