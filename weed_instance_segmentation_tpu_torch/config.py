"""Global configuration, read from ``WISTPU_*`` environment variables at
import.

Copied by value from ``weed_instance_segmentation_tpu/config.py`` (importing
that module would run the JAX package's ``__init__``): each name here has the
same default and override as there, so one environment configures both
packages. Only the names a port module reads are here. Entry points read
these as module attributes (``config.BATCH_SIZE``); tests set them with
``monkeypatch.setattr``.
"""

import os


def _env(name, default, cast=str):
    raw = os.environ.get(f'WISTPU_{name}')
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ('1', 'true', 'yes')
    if default is None and raw.lower() in ('none', ''):
        return None
    return cast(raw)


# Training
MODEL_CHECKPOINT = _env('MODEL_CHECKPOINT', 'facebook/mask2former-swin-large-coco-instance')
BATCH_SIZE = _env('BATCH_SIZE', 2, int)
LEARNING_RATE = _env('LEARNING_RATE', 5e-5, float)
EPOCHS = _env('EPOCHS', 100, int)
GRADIENT_ACCUMULATION = _env('GRADIENT_ACCUMULATION', 2, int)

# Data
MAX_INPUT_DIM = _env('MAX_INPUT_DIM', 1024, int)
MAX_IMAGES = _env('MAX_IMAGES', None, int)  # None for the full dataset, an int for debugging
DATASET_LIST = [
    # 'sorghum_weed',
    'pheno_bench',
    # 'crop_weed',
]
if os.environ.get('WISTPU_DATASET_LIST'):
    DATASET_LIST = os.environ['WISTPU_DATASET_LIST'].split(',')
FORCE_PREPROCESSING = _env('FORCE_PREPROCESSING', False, bool)

# Output directories
OUTPUT_DIR = _env('OUTPUT_DIR', os.path.expanduser('~/weed_instance_segmentation_tpu_output/'))
MODELS_OUTPUT_DIR = OUTPUT_DIR + 'models/'

# Ground-truth instances per image after padding to the static batch shape
MAX_INSTANCES = _env('MAX_INSTANCES', 100, int)

# The static batch's height and width are rounded up to this multiple
PAD_TO_MULTIPLE = _env('PAD_TO_MULTIPLE', 32, int)

# Compute dtype of the model (training keeps float32 parameters)
COMPUTE_DTYPE = _env('COMPUTE_DTYPE', 'float32')

# Recompute activations in the backward: 0/false (store everything), 1/true
# (backbone + deformable encoder), 'encoder' (deformable encoder only)
_remat_raw = os.environ.get('WISTPU_REMAT', '')
if _remat_raw.lower() == 'encoder':
    REMAT: bool | str = 'encoder'
else:
    REMAT = _env('REMAT', False, bool)

# Data- and model-parallel degrees (None = all visible devices); the port
# trains on one device so far, and the trainer refuses a degree above 1
DATA_PARALLEL = _env('DATA_PARALLEL', None, int)
MODEL_PARALLEL = _env('MODEL_PARALLEL', None, int)

# Resume training: a run directory holding train_state/, or a train_state
# directory written by engine/checkpoint.py::save_train_checkpoint
RESUME = _env('RESUME', None)

# File suffix of the pre-processed cache, one file per sample
CACHE_SUFFIX = '.npz'

# Architecture when MODEL_CHECKPOINT is not a local checkpoint directory
# (nothing is downloaded: the model is then initialised from scratch):
# 'swin-tiny', 'swin-small', 'swin-base', 'swin-large' or 'tiny-test'
MODEL_ARCH = _env('MODEL_ARCH', 'swin-large')

# Image processor geometry (the HF checkpoints' 800 / 1333)
SHORTEST_EDGE = _env('SHORTEST_EDGE', 800, int)
LONGEST_EDGE = _env('LONGEST_EDGE', 1333, int)
