"""Global configuration, read from ``WISTPU_*`` environment variables at
import.

Copied by value from ``weed_instance_segmentation_tpu/config.py`` (importing
that module would run the JAX package's ``__init__``): each name here has the
same default and override as there, so one environment configures both
packages. Only the names a port module reads are here; the others (training
hyper-parameters, data limits, the device mesh, resume, processor geometry)
come with the slice that first reads them. Entry points read these as module
attributes (``config.BATCH_SIZE``); tests set them with
``monkeypatch.setattr``.
"""

import os


def _env(name, default, cast=str):
    raw = os.environ.get(f'WISTPU_{name}')
    if raw is None:
        return default
    return cast(raw)


BATCH_SIZE = _env('BATCH_SIZE', 2, int)

DATASET_LIST = [
    # 'sorghum_weed',
    'pheno_bench',
    # 'crop_weed',
]
if os.environ.get('WISTPU_DATASET_LIST'):
    DATASET_LIST = os.environ['WISTPU_DATASET_LIST'].split(',')

# Output directories
OUTPUT_DIR = _env('OUTPUT_DIR', os.path.expanduser('~/weed_instance_segmentation_tpu_output/'))
MODELS_OUTPUT_DIR = OUTPUT_DIR + 'models/'

# Compute dtype of the model (training keeps float32 parameters)
COMPUTE_DTYPE = _env('COMPUTE_DTYPE', 'float32')
