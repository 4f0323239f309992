"""sorghum_weed dataset definitions, copied by value from
``weed_instance_segmentation_tpu/datasets/sorghum_weed/definitions.py``."""

import os

DATASET_ROOT = os.environ.get(
    'WISTPU_SORGHUM_WEED_ROOT',
    os.path.expanduser('~/data/SorghumWeedDataset_Segmentation/'),
)

TRAIN_IMG_DIR = os.path.join(DATASET_ROOT, 'Train/')
TRAIN_ANNOTATIONS = os.path.join(DATASET_ROOT, 'Annotations/TrainSorghumWeed_json.json')

VAL_IMG_DIR = os.path.join(DATASET_ROOT, 'Validate/')
VAL_ANNOTATIONS = os.path.join(DATASET_ROOT, 'Annotations/ValidateSorghumWeed_json.json')

TEST_IMG_DIR = os.path.join(DATASET_ROOT, 'Test/')
TEST_ANNOTATIONS = os.path.join(DATASET_ROOT, 'Annotations/TestSorghumWeed_json.json')

PROCESSED_DIR = os.path.join(DATASET_ROOT, 'Processed/')

ID2LABEL = {
    0: 'Sorghum',
    1: 'BLweed',
    2: 'Grass',
}
LABEL2ID = {v: k for k, v in ID2LABEL.items()}
