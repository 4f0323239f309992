"""Training entry point: raw data → ``.npz`` cache → epochs → best-val
checkpoint → test phase.

    python -m weed_instance_segmentation_tpu_torch.engine.train

Port of ``weed_instance_segmentation_tpu/engine/train.py``:

- unified label maps over ``config.DATASET_LIST``, the first label winning
  an id collision, with a warning;
- each dataset pre-processed into the ``.npz`` cache where its splits are
  missing (``ensure_preprocessed``; reading raw images needs PIL, so on a
  machine without it the cache must exist already);
- one static batch shape for the whole run (``compute_static_pad_hw``), the
  last short batch padded with repeats that are marked invalid;
- the epoch loop: ``config.GRADIENT_ACCUMULATION`` micro-steps an update, a
  cycle running on across epochs as ``optax.MultiSteps`` carries it; the
  validation loss averaged per batch; ``best_model/`` saved when it
  improves; the resume point ``train_state/`` after every epoch;
  ``final_model/`` at the end; ``WISTPU_RESUME`` continues a run from its
  ``train_state/``, the shuffle and random draws of an uninterrupted run
  included;
- the test phase on ``best_model/`` in float32, as the JAX trainer runs it;
- ``metadata.json`` with the JAX trainer's keys and timings, written first
  and again at the end; an exception inside ``train()`` is printed and the
  metadata gathered so far returned.

It runs on the card; ``WISTPU_DEVICE=cpu`` runs it on the CPU (the
counterpart of ``JAX_PLATFORMS=cpu``). ``WISTPU_AUGMENT=1`` turns on the
device-side augmentation (``processing/augment.py``). ``WISTPU_PROFILE=<dir>``
writes a ``torch.profiler`` trace of micro-steps 3-8 there and records the
device's busy share over them as ``device_duty_profiled``.

Run as W processes (``parallel/mesh.py``: ``WISTPU_COORDINATOR`` /
``WISTPU_NUM_PROCESSES`` / ``WISTPU_PROCESS_ID``, or ``torchrun`` with
``WISTPU_MULTIHOST=auto``), it trains on ``DATA_PARALLEL`` × ``MODEL_PARALLEL``
ranks as the JAX trainer does on its mesh: rank 0 fills the cache while the
others wait; ``BATCH_SIZE`` is rounded up to the data axis; each rank loads
its own rows of every train and validation batch, and of the test split;
the model is DDP-wrapped, or FSDP2-sharded over 'model'; the losses in the
history are the global batches'; every rank joins the saves, which rank 0
writes (and ``metadata.json``); the test phase shards the split over every
rank and merges the metric entries on rank 0. All ranks use rank 0's start
time for the run directory.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from datetime import datetime

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import (
    TRAIN_SAMPLE_KEYS, ConcatDataset, PreprocessedDataset, collate_fn, compute_static_pad_hw,
    make_train_collate, process_and_save,
)
from weed_instance_segmentation_tpu_torch.datasets.factory import get_dataset_and_config
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader, device_batches
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.engine.metrics import (
    prepare_metrics_for_json, print_metrics_evaluation, test_with_metrics,
)
from weed_instance_segmentation_tpu_torch.engine.model_utils import (
    build_model_for_labels, default_processor, require_device,
)
from weed_instance_segmentation_tpu_torch.engine.steps import (
    make_eval_step, make_forward_fn, make_optimizer, make_train_step, step_draws,
)
from weed_instance_segmentation_tpu_torch.engine.test import load_test_model
from weed_instance_segmentation_tpu_torch.parallel.mesh import (
    barrier, broadcast_pyobject, create_mesh, data_coordinate, is_main,
    maybe_initialize_distributed, process_count, process_index, rank_device, unwrap, wrap_model,
)
from weed_instance_segmentation_tpu_torch.processing.augment import from_env as augment_from_env

SPLITS = ('Train', 'Validate', 'Test')
TRAIN_SEED = 42  # the JAX trainer's PRNGKey(42)
SYNC_EVERY = 8  # micro-steps between waits for the device's loss
PROFILE_STEPS = (3, 8)  # micro-steps of this process traced under WISTPU_PROFILE


def get_unified_labels(dataset_list: list) -> tuple[dict, dict]:
    """Merge the datasets' ID2LABEL maps; on an id collision the first
    label wins, with a warning."""
    unified_id2label: dict = {}
    for ds_name in dataset_list:
        _, ds_config = get_dataset_and_config(ds_name)
        for id_num, label in ds_config.ID2LABEL.items():
            if id_num in unified_id2label and unified_id2label[id_num] != label:
                print(f'WARNING: ID collision for {id_num} '
                      f'({unified_id2label[id_num]} vs {label}). '
                      f'Keeping {unified_id2label[id_num]}.')
            else:
                unified_id2label[id_num] = label
    unified_label2id = {v: k for k, v in unified_id2label.items()}
    print(f'Unified Classes: {unified_id2label}')
    return unified_id2label, unified_label2id


def format_duration(start_dt: datetime, end_dt: datetime) -> str:
    return str(end_dt - start_dt).split('.')[0]


def ensure_preprocessed(dataset_name: str, processor, unified_label2id: dict) -> dict:
    """Write the dataset's missing (or, with FORCE_PREPROCESSING, every)
    splits into the cache; returns the three split directories."""
    WeedDataset, ds_config = get_dataset_and_config(dataset_name)
    paths = {s: os.path.join(ds_config.PROCESSED_DIR, s) for s in SPLITS}

    if hasattr(ds_config, 'TRAIN_VAL_TEST_SPLIT'):
        # dynamic-split datasets (crop_weed) have no per-split raw folders:
        # datasets/preprocess.py's seeded split writes all three
        from weed_instance_segmentation_tpu_torch.datasets.preprocess import preprocess_dataset

        missing = any(
            not os.path.exists(p) or len(os.listdir(p)) == 0
            for s, p in paths.items() if ds_config.TRAIN_VAL_TEST_SPLIT[SPLITS.index(s)] > 0
        )
        if missing or config.FORCE_PREPROCESSING:
            preprocess_dataset(dataset_name, processor, unified_label2id, force=True)
        # a split of ratio 0 has no directory and reads as empty
        return paths

    for split, img_attr, ann_attr in (
        ('Train', 'TRAIN_IMG_DIR', 'TRAIN_ANNOTATIONS'),
        ('Validate', 'VAL_IMG_DIR', 'VAL_ANNOTATIONS'),
        ('Test', 'TEST_IMG_DIR', 'TEST_ANNOTATIONS'),
    ):
        proc_path = paths[split]
        if (not os.path.exists(proc_path) or len(os.listdir(proc_path)) == 0
                or config.FORCE_PREPROCESSING):
            print(f'\tPre-processing {dataset_name} {split} data...')
            raw = WeedDataset(
                image_folder_path=getattr(ds_config, img_attr),
                annotation_path=getattr(ds_config, ann_attr),
                processor=processor,
                label2id=unified_label2id,
            )
            process_and_save(raw, output_dir=proc_path)
    return paths


def evaluate(eval_step, loader, device: torch.device, mesh=None) -> float:
    """The validation loss averaged per batch; batch i draws from
    (0, i), as the JAX trainer's ``evaluate`` does (this rank's rows of
    the draws on ``mesh``)."""
    shard = None if mesh is None else data_coordinate(mesh)
    losses = [eval_step(batch, step_draws(0, i, device, shard))  # on the device until the end
              for i, batch in enumerate(device_batches(loader, device))]
    total = float(np.sum([loss.item() for loss in losses])) if losses else 0.0
    return total / max(len(losses), 1)


def _device_busy_fraction(trace_path: str) -> float | None:
    """The share of the trace's span in which the device ran a kernel, copy
    or fill (their intervals merged); None if it holds no device work."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    device = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                    if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'))
    if not device:
        return None
    busy, end = 0.0, -float('inf')
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(e['ts'] + e['dur'] for e in events) - min(e['ts'] for e in events)
    return busy / span if span > 0 else None


def _start_profile(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, device: torch.device, metadata: dict) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, 'trace.json')
    prof.export_chrome_trace(path)
    print(f'\tProfiler trace written to {path}')
    busy = _device_busy_fraction(path)
    if busy is not None:
        metadata['device_duty_profiled'] = round(busy, 4)
        print(f'\tProfiled device-busy fraction: {100 * busy:.1f}%')


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def train(output_dir: str, metadata: dict, dataset_list: list,
          device: str | torch.device = 'cuda') -> dict:
    device = require_device(device, 'train')
    multiprocess = maybe_initialize_distributed(device)
    device = rank_device(device)
    main_rank = is_main()
    mesh = create_mesh(config.DATA_PARALLEL, config.MODEL_PARALLEL, device)
    try:
        start_time = datetime.now()
        print(f'Training on {device}' + (
            f', mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} of {process_count()} '
            f'processes (this is process {process_index()})' if multiprocess else ''))

        # 1. unified labels + processor
        unified_id2label, unified_label2id = get_unified_labels(dataset_list)
        processor = default_processor()

        # 2. the cache, then datasets over it; rank 0 fills the cache while
        # the others wait (a shared filesystem, as on the JAX package's pods)
        train_datasets, val_datasets, test_datasets, processed_dirs = [], [], [], []
        for dataset_name in dataset_list:
            print(f'\n--- Preparing Dataset: {dataset_name} ---')
            if main_rank:
                paths = ensure_preprocessed(dataset_name, processor, unified_label2id)
            barrier()
            if not main_rank:
                _, ds_config = get_dataset_and_config(dataset_name)
                paths = {s: os.path.join(ds_config.PROCESSED_DIR, s) for s in SPLITS}
            # train/val feed only the loss: the three keys it reads; the test
            # split keeps the full sample (the metric rebuilds the ground
            # truth from original_map)
            train_datasets.append(PreprocessedDataset(paths['Train'], keys=TRAIN_SAMPLE_KEYS))
            val_datasets.append(PreprocessedDataset(paths['Validate'], keys=TRAIN_SAMPLE_KEYS))
            test_datasets.append(PreprocessedDataset(paths['Test']))
            processed_dirs.extend(paths.values())

        full_train = ConcatDataset(train_datasets)
        full_val = ConcatDataset(val_datasets)
        full_test = ConcatDataset(test_datasets)
        print(f'\n\tCombined Training Samples: {len(full_train)}')
        print(f'\tCombined Validation Samples: {len(full_val)}')
        print(f'\tCombined Test Samples: {len(full_test)}')

        pad_hw, data_max_instances = compute_static_pad_hw(processed_dirs)
        max_instances = min(max(data_max_instances, 1), config.MAX_INSTANCES)
        print(f'\tStatic batch shape: {pad_hw}, max_instances={max_instances}')

        end_time = datetime.now()
        elapsed = format_duration(start_time, end_time)
        print(f'\tData preprocessing completed in {elapsed}')
        metadata['preprocessing_time'] = elapsed
        start_time = end_time

        # the batch fills the data axis (ranks of one model group share rows)
        data_index, data_size = data_coordinate(mesh)
        batch_size = _round_up(config.BATCH_SIZE, data_size)
        if batch_size != config.BATCH_SIZE:
            print(f'\tBATCH_SIZE {config.BATCH_SIZE} rounded to {batch_size} for '
                  f'{data_size} data ranks')
        shard = dict(process_index=data_index, process_count=data_size)
        train_collate = make_train_collate(pad_hw, max_instances, batch_size // data_size)
        train_loader = DataLoader(full_train, batch_size, train_collate, shuffle=True, **shard)
        val_loader = DataLoader(full_val, batch_size, train_collate, **shard)
        # the test phase runs an unsharded model on every rank: its rows
        # split over all of them
        world = process_count()
        test_loader = DataLoader(full_test, _round_up(batch_size, world), collate_fn,
                                 process_index=process_index(), process_count=world)

        # 3. model, optimizer, steps
        model, model_cfg = build_model_for_labels(unified_id2label, unified_label2id,
                                                  device=device)
        compute_dtype = getattr(torch, config.COMPUTE_DTYPE)
        resume_dir = None
        if config.RESUME:
            resume_dir = config.RESUME
            if not os.path.exists(os.path.join(resume_dir, ckpt.OPT_STATE_FILE)):
                resume_dir = os.path.join(resume_dir, 'train_state')
        model = wrap_model(model, mesh, device)
        optimizer = make_optimizer(model.parameters(), config.LEARNING_RATE)
        augment = augment_from_env()
        if augment is not None:
            print(f'Device-side augmentation enabled: {augment}')
            metadata['augmentation'] = str(augment)
        train_step = make_train_step(model, model_cfg, optimizer, config.GRADIENT_ACCUMULATION,
                                     compute_dtype, seed=TRAIN_SEED, augment=augment, mesh=mesh)
        eval_step = make_eval_step(model, model_cfg, compute_dtype, mesh=mesh)

        best_val_loss = float('inf')
        start_epoch = 0
        metadata['training_history'] = []
        if resume_dir is not None:
            resume_meta = ckpt.load_train_checkpoint(resume_dir, model, optimizer, train_step)
            start_epoch = int(resume_meta.get('epoch', 0))
            best_val_loss = float(resume_meta.get('best_val_loss', float('inf')))
            metadata['training_history'] = list(resume_meta.get('training_history', []))
            metadata['resumed_from'] = resume_dir
            print(f'Resumed from {resume_dir}: epoch {start_epoch}, micro-step '
                  f'{train_step.micro_steps}, best val loss {best_val_loss:.4f}')
            # epoch k draws the batch order it would have drawn uninterrupted
            train_loader.set_epoch(start_epoch)
        print('Starting Training...')

        end_time = datetime.now()
        elapsed = format_duration(start_time, end_time)
        print(f'\tData and model loading completed in {elapsed}')
        metadata['data_and_model_loading_time'] = elapsed
        start_time = end_time

        profile_dir = os.environ.get('WISTPU_PROFILE')
        prof = None
        global_step = 0
        input_wait = 0.0  # host time spent waiting for a batch
        device_time = 0.0  # host time spent in the steps
        for epoch in range(start_epoch, config.EPOCHS):
            epoch_losses = []
            print(f'\nEpoch {epoch + 1}/{config.EPOCHS}')
            t_mark = time.perf_counter()
            for batch in device_batches(train_loader, device):
                t_have_batch = time.perf_counter()
                input_wait += t_have_batch - t_mark
                if profile_dir and global_step == PROFILE_STEPS[0]:
                    prof = _start_profile(device)
                loss = train_step(batch)  # the global batch's, on every rank
                epoch_losses.append(loss)  # on the device; waited for every SYNC_EVERY
                global_step += 1
                if len(epoch_losses) % SYNC_EVERY == 0:
                    loss.item()
                if prof is not None and global_step == PROFILE_STEPS[1]:
                    try:
                        _stop_profile(prof, profile_dir, device, metadata)
                    except Exception as e:
                        print(f'\tTrace parse failed (non-fatal): {e}')
                    prof, profile_dir = None, None
                t_mark = time.perf_counter()
                device_time += t_mark - t_have_batch
            avg_train_loss = (float(np.mean([loss.item() for loss in epoch_losses]))
                              if epoch_losses else 0.0)
            print(f'\tEpoch {epoch + 1} Avg Loss: {avg_train_loss:.4f}')

            avg_val_loss = evaluate(eval_step, val_loader, device, mesh)
            print(f'\tEpoch {epoch + 1} Val Loss: {avg_val_loss:.4f}')
            metadata['training_history'].append({
                'epoch': epoch + 1,
                'train_loss': avg_train_loss,
                'val_loss': avg_val_loss,
            })

            # every rank joins the saves (their gathers are collectives);
            # rank 0 writes
            if avg_val_loss < best_val_loss:
                best_val_loss = avg_val_loss
                ckpt.save_pretrained(os.path.join(output_dir, 'best_model'),
                                     unwrap(model).state_dict(), model_cfg, processor)
                print(f'\tSaved new best model (Loss: {best_val_loss:.4f})')

            ckpt.save_train_checkpoint(
                os.path.join(output_dir, 'train_state'), model, optimizer, train_step,
                extra={'epoch': epoch + 1, 'best_val_loss': best_val_loss,
                       'training_history': metadata['training_history']})
        if prof is not None:  # fewer micro-steps than the traced window
            prof.stop()

        end_time = datetime.now()
        elapsed = format_duration(start_time, end_time)
        print(f'\tTraining completed in {elapsed}')
        metadata['training_time'] = elapsed
        # the share of the loop's host time spent in steps rather than
        # waiting for the input pipeline
        total_loop = input_wait + device_time
        if total_loop > 0:
            duty = device_time / total_loop
            metadata['input_duty_cycle'] = round(duty, 4)
            print(f'\tInput-pipeline duty cycle: {100 * duty:.1f}%')

        ckpt.save_pretrained(os.path.join(output_dir, 'final_model'),
                             unwrap(model).state_dict(), model_cfg, processor)
        ckpt.save_train_checkpoint(
            os.path.join(output_dir, 'train_state'), model, optimizer, train_step,
            extra={'epoch': config.EPOCHS, 'best_val_loss': best_val_loss,
                   'training_history': metadata['training_history']})
        del model, optimizer, train_step, eval_step
        if device.type == 'cuda':
            torch.cuda.empty_cache()

        # 4. test phase on the best model, in float32; best_model/ is whole
        # on disk before any rank reads it
        start_time = datetime.now()
        best_model_path = os.path.join(output_dir, 'best_model')
        barrier()
        print('\n--- Starting Test Phase (Best Model) ---')
        if os.path.exists(best_model_path):
            print(f'\tLoading best model from {best_model_path}')
            best = load_test_model(best_model_path, device)
            test_results = test_with_metrics(make_forward_fn(best), test_loader, device=device,
                                             pad_hw=pad_hw)
            del best
            if main_rank:
                print_metrics_evaluation(test_results, model_name='Best Model')
                metadata['test_metrics'] = prepare_metrics_for_json(test_results)
        else:
            print('\tBest model not found, skipping test phase.')

        end_time = datetime.now()
        elapsed = format_duration(start_time, end_time)
        print(f'\tTest completed in {elapsed}')
        metadata['test_time'] = elapsed
        barrier()
        return metadata

    except Exception as e:  # the metadata gathered so far
        traceback.print_exc()
        print(f'\nError during training/testing:\n\t{e}')
        return metadata


def main() -> None:
    device = os.environ.get('WISTPU_DEVICE', 'cuda')
    maybe_initialize_distributed(device)
    # every rank names the run directory by rank 0's clock
    global_start_time = broadcast_pyobject(datetime.now())
    run_output_dir = os.path.join(config.MODELS_OUTPUT_DIR, 'mask2former_fine_tuned',
                                  global_start_time.strftime('%Y-%m-%d_%H-%M-%S'))
    if is_main():
        os.makedirs(run_output_dir, exist_ok=True)
    print(f'Training started at {global_start_time.strftime("%Y-%m-%d %H:%M:%S")}')

    metadata = {
        'start_time': global_start_time.strftime('%Y-%m-%d_%H-%M-%S'),
        'dataset_list': config.DATASET_LIST,
        'base_model': config.MODEL_CHECKPOINT,
        'batch_size': config.BATCH_SIZE,
        'learning_rate': config.LEARNING_RATE,
        'epochs': config.EPOCHS,
        'gradient_accumulation': config.GRADIENT_ACCUMULATION,
        'max_input_dim': config.MAX_INPUT_DIM,
    }
    metadata_path = os.path.join(run_output_dir, 'metadata.json')
    if is_main():
        try:
            with open(metadata_path, 'w') as f:
                json.dump(metadata, f, indent=4)
        except Exception as e:
            print(f'\nError in saving metadata to "{metadata_path}":\n\t {e}')

    updated = train(output_dir=run_output_dir, metadata=metadata,
                    dataset_list=config.DATASET_LIST, device=device)
    global_end_time = datetime.now()
    updated['end_time'] = global_end_time.strftime('%Y-%m-%d_%H-%M-%S')
    updated['total_time'] = format_duration(global_start_time, global_end_time)
    print(f"Training finished at {updated['end_time']}, "
          f"total duration: {updated['total_time']}")
    if is_main():
        try:
            with open(metadata_path, 'w') as f:
                json.dump(updated, f, indent=4)
        except Exception as e:
            print(f'\nError in updating metadata to "{metadata_path}":\n\t {e}')


if __name__ == '__main__':
    main()
