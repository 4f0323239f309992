"""pheno_bench dataset definitions, copied by value from
``weed_instance_segmentation_tpu/datasets/pheno_bench/definitions.py``."""

import os

DATASET_ROOT = os.environ.get(
    'WISTPU_PHENO_BENCH_ROOT',
    os.path.expanduser('~/data/PhenoBench/'),
)

TRAIN_IMG_DIR = os.path.join(DATASET_ROOT, 'train/images/')
TRAIN_ANNOTATIONS = os.path.join(DATASET_ROOT, 'train/semantics/')

VAL_IMG_DIR = os.path.join(DATASET_ROOT, 'val/images/')
VAL_ANNOTATIONS = os.path.join(DATASET_ROOT, 'val/semantics/')

TEST_IMG_DIR = os.path.join(DATASET_ROOT, 'test/images/')
TEST_ANNOTATIONS = os.path.join(DATASET_ROOT, 'test/semantics/')

PROCESSED_DIR = os.path.join(DATASET_ROOT, 'Processed/')

ID2LABEL = {
    0: 'background',
    1: 'crop',
    2: 'weed',
    3: 'partial-crop',
    4: 'partial-weed',
}
LABEL2ID = {v: k for k, v in ID2LABEL.items()}
