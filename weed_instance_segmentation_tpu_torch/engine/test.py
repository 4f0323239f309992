"""Standalone evaluation entry point: a saved model's COCO mAP on a test split.

    python -m weed_instance_segmentation_tpu_torch.engine.test

Port of ``weed_instance_segmentation_tpu/engine/test.py``. It loads the
checkpoint ``WISTPU_MODEL_ID`` (under ``config.MODELS_OUTPUT_DIR``; a
``latest`` component resolves to the newest run), reads the ``Test`` split of
``config.DATASET_LIST[0]`` from its pre-processed ``.npz`` cache
(``<PROCESSED_DIR>/Test``), runs ``engine/metrics.py::test_with_metrics``
over it in batches of ``config.BATCH_SIZE``, prints the summary and returns
the metric dict. The model computes in ``config.COMPUTE_DTYPE``.

It runs on the card. The CPU is used only when asked: ``test_model(...,
device='cpu')``, or ``WISTPU_DEVICE=cpu`` for ``python -m`` (the counterpart
of ``JAX_PLATFORMS=cpu``); without a card the default raises.

Known difference: where a dataset has a predefined test folder
(``TEST_IMG_DIR``: pheno_bench, sorghum_weed) the JAX entry point reads the raw
images through the image processor. That route needs the PIL readers, which
are not ported yet, so this entry point reads the cache for every dataset; the
raw route comes with the datasets slice.
"""

from __future__ import annotations

import importlib
import os

import torch

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import (
    PreprocessedDataset, collate_fn,
)
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader
from weed_instance_segmentation_tpu_torch.engine.metrics import (
    print_metrics_evaluation, test_with_metrics,
)
from weed_instance_segmentation_tpu_torch.engine.model_utils import load_model, resolve_model_path
from weed_instance_segmentation_tpu_torch.engine.steps import make_forward_fn

MODEL_ID = os.environ.get('WISTPU_MODEL_ID', 'mask2former_fine_tuned/latest/best_model/')


def dataset_definitions(dataset_name: str):
    """The ``datasets/<name>/definitions.py`` module of ``dataset_name``."""
    path = f'weed_instance_segmentation_tpu_torch.datasets.{dataset_name}.definitions'
    try:
        return importlib.import_module(path)
    except ImportError:
        raise ValueError(f'no definitions module for dataset {dataset_name!r} — '
                         f'expected an importable "{path}"') from None


def test_model(model_id: str, device: str | torch.device = 'cuda') -> dict | None:
    model_path = resolve_model_path(model_id)
    if not os.path.exists(model_path):
        print(f'Model not found at {model_path}')
        return None

    ds_config = dataset_definitions(config.DATASET_LIST[0])
    print('Loading Test Dataset...')
    test_dir = os.path.join(ds_config.PROCESSED_DIR, 'Test')
    if not os.path.isdir(test_dir):
        if hasattr(ds_config, 'TEST_IMG_DIR'):
            print(f'No preprocessed cache at {test_dir} (the raw test folder '
                  f'{ds_config.TEST_IMG_DIR} needs the image readers, not ported yet) — '
                  f'run datasets.preprocess first')
        else:
            print(f'No predefined test split and no preprocessed cache at '
                  f'{test_dir} — run datasets.preprocess first')
        return None
    loader = DataLoader(PreprocessedDataset(test_dir), batch_size=config.BATCH_SIZE,
                        collate=collate_fn, shuffle=False)

    print(f'Loading model from {model_path}')
    model, _ = load_model(model_id, device)
    result = test_with_metrics(make_forward_fn(model), loader, device=device)
    print_metrics_evaluation(result, model_name='Best Model')
    return result


if __name__ == '__main__':
    test_model(MODEL_ID, device=os.environ.get('WISTPU_DEVICE', 'cuda'))
