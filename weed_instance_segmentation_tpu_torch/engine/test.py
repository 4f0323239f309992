"""Standalone evaluation entry point: a saved model's COCO mAP on a test split.

    python -m weed_instance_segmentation_tpu_torch.engine.test

Port of ``weed_instance_segmentation_tpu/engine/test.py``. It loads the
checkpoint ``WISTPU_MODEL_ID`` (under ``config.MODELS_OUTPUT_DIR``; a
``latest`` component resolves to the newest run) and builds the model in
float32 whatever ``config.COMPUTE_DTYPE`` says, as the JAX entry point does. The
test split of ``config.DATASET_LIST[0]``: where the dataset has a predefined
test folder (``TEST_IMG_DIR``: pheno_bench, sorghum_weed), the raw images
read through the checkpoint's image processor (``preprocessor_config.json``;
this needs PIL); otherwise (crop_weed) its pre-processed ``.npz`` cache,
``<PROCESSED_DIR>/Test``. It runs ``engine/metrics.py::test_with_metrics``
over the split in batches of ``config.BATCH_SIZE``, prints the summary and
returns the metric dict.

It runs on the card. The CPU is used only when asked: ``test_model(...,
device='cpu')``, or ``WISTPU_DEVICE=cpu`` for ``python -m`` (the counterpart
of ``JAX_PLATFORMS=cpu``); without a card the default raises.

Run as W processes (``parallel/mesh.py::maybe_initialize_distributed``:
``WISTPU_COORDINATOR`` / ``WISTPU_NUM_PROCESSES`` / ``WISTPU_PROCESS_ID``, or
``torchrun`` with ``WISTPU_MULTIHOST=auto``), each process reads and scores
its own rows of every batch, as the JAX entry point shards the split over
``create_mesh(DATA_PARALLEL)``; rank 0 prints and returns the metrics, the
others return ``{}``.
"""

from __future__ import annotations

import os

import torch

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import (
    PreprocessedDataset, collate_fn,
)
from weed_instance_segmentation_tpu_torch.datasets.factory import get_dataset_and_config
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.engine.metrics import (
    print_metrics_evaluation, test_with_metrics,
)
from weed_instance_segmentation_tpu_torch.engine.model_utils import (
    model_from_state_dict, resolve_model_path,
)
from weed_instance_segmentation_tpu_torch.engine.steps import make_forward_fn
from weed_instance_segmentation_tpu_torch.parallel.mesh import (
    create_mesh, is_main, maybe_initialize_distributed, process_count, process_index,
    rank_device,
)

MODEL_ID = os.environ.get('WISTPU_MODEL_ID', 'mask2former_fine_tuned/latest/best_model/')


def load_test_model(model_path: str, device: str | torch.device = 'cuda'):
    """The model of the checkpoint directory ``model_path`` in float32 on
    ``device``, as both packages' test entry points evaluate it."""
    cfg, state_dict = ckpt.load_pretrained(model_path)
    return model_from_state_dict(cfg, state_dict, torch.float32, device)


def test_model(model_id: str, device: str | torch.device = 'cuda') -> dict | None:
    maybe_initialize_distributed(device)
    device = rank_device(device)
    create_mesh(config.DATA_PARALLEL, device=device)  # raises where the degree and W differ
    model_path = resolve_model_path(model_id)
    if not os.path.exists(model_path):
        print(f'Model not found at {model_path}')
        return None

    WeedDataset, ds_config = get_dataset_and_config(config.DATASET_LIST[0])
    print('Loading Test Dataset...')
    if hasattr(ds_config, 'TEST_IMG_DIR'):
        test_ds = WeedDataset(
            image_folder_path=ds_config.TEST_IMG_DIR,
            annotation_path=ds_config.TEST_ANNOTATIONS,
            processor=ckpt.load_processor(model_path),
            label2id=ds_config.LABEL2ID,
        )
    else:
        # dynamic-split datasets (crop_weed) have no test folder: their test
        # samples exist only in the cache datasets/preprocess.py writes
        test_dir = os.path.join(ds_config.PROCESSED_DIR, 'Test')
        if not os.path.isdir(test_dir):
            print(f'No predefined test split and no preprocessed cache at '
                  f'{test_dir} — run datasets.preprocess first')
            return None
        test_ds = PreprocessedDataset(test_dir)
    world = process_count()
    batch_size = -(-config.BATCH_SIZE // world) * world  # whole rows on every rank
    loader = DataLoader(test_ds, batch_size=batch_size, collate=collate_fn, shuffle=False,
                        process_index=process_index(), process_count=world)

    print(f'Loading model from {model_path}')
    model = load_test_model(model_path, device)
    result = test_with_metrics(make_forward_fn(model), loader, device=device)
    if is_main():
        print_metrics_evaluation(result, model_name='Best Model')
    return result


if __name__ == '__main__':
    test_model(MODEL_ID, device=os.environ.get('WISTPU_DEVICE', 'cuda'))
