"""crop_weed (CWFID) dataset definitions, copied by value from
``weed_instance_segmentation_tpu/datasets/crop_weed/definitions.py``."""

import os

DATASET_ROOT = os.environ.get(
    'WISTPU_CROP_WEED_ROOT',
    os.path.expanduser('~/data/CropWeedFieldImageDataset/'),
)

IMG_DIR = os.path.join(DATASET_ROOT, 'images/')
ANNOTATIONS = os.path.join(DATASET_ROOT, 'annotations/')

PROCESSED_DIR = os.path.join(DATASET_ROOT, 'Processed/')

# How to split the data when no predefined split directories exist; a split
# of 0 means that set is not created ("0.6,0.2,0.2" in the env gives a test
# split, which engine/test.py reads from the cache)
TRAIN_VAL_TEST_SPLIT = [
    float(v)
    for v in os.environ.get('WISTPU_CROP_WEED_SPLIT', '0.8,0.2,0').split(',')
]
if abs(sum(TRAIN_VAL_TEST_SPLIT) - 1.0) > 1e-6:
    raise ValueError(
        f'TRAIN_VAL_TEST_SPLIT must sum to 1.0, but got {sum(TRAIN_VAL_TEST_SPLIT)}'
    )

# 'png' (RGB semantic masks, instances by connected components) or 'yaml'
# (per-instance polygon contours)
ANNOTATION_FORMAT = os.environ.get('WISTPU_CROP_WEED_FORMAT', 'png')

ID2LABEL = {
    0: 'crop',
    1: 'weed',
}
LABEL2ID = {v: k for k, v in ID2LABEL.items()}
