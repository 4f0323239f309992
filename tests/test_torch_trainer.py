"""The port's trainer (``engine/train.py``) on the CPU at tiny-test, against
the JAX package: a run from raw pheno_bench and crop_weed fixtures with the
settings of ``tests/test_end_to_end.py``, its checkpoints read by the JAX
package and its test metrics held to the JAX package's float32
``test_with_metrics``; a run resumed from its train state against an
uninterrupted one, bit for bit; and the parallel and augmentation settings
in one process."""

import contextlib
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from fixtures import make_crop_weed_png, make_pheno_bench

from weed_instance_segmentation_tpu import config as jax_config
from weed_instance_segmentation_tpu.datasets import dataset_utils as jax_dataset_utils
from weed_instance_segmentation_tpu.datasets.loader import DataLoader as JaxDataLoader
from weed_instance_segmentation_tpu.engine import checkpoint as jax_ckpt
from weed_instance_segmentation_tpu.engine import metrics as jax_metrics
from weed_instance_segmentation_tpu.engine import model_utils as jax_model_utils
from weed_instance_segmentation_tpu.engine.steps import make_forward_fn as jax_make_forward_fn
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets import dataset_utils
from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions as crop_weed
from weed_instance_segmentation_tpu_torch.datasets.pheno_bench import definitions as pheno_bench
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.engine import metrics, train
from weed_instance_segmentation_tpu_torch.engine.model_utils import (
    build_model, build_model_for_labels, default_processor,
)
from weed_instance_segmentation_tpu_torch.engine.steps import (
    make_forward_fn, make_optimizer, make_train_step,
)
from weed_instance_segmentation_tpu_torch.engine.test import load_test_model
from weed_instance_segmentation_tpu_torch.processing import image_processor

# the settings of tests/test_end_to_end.py
E2E = {'DATASET_LIST': ['pheno_bench', 'crop_weed'], 'EPOCHS': 1, 'MAX_IMAGES': 2,
       'BATCH_SIZE': 2, 'MODEL_ARCH': 'tiny-test', 'SHORTEST_EDGE': 64, 'LONGEST_EDGE': 96,
       'MAX_INSTANCES': 8, 'DATA_PARALLEL': 1}
METADATA_KEYS = ('start_time', 'dataset_list', 'base_model', 'batch_size', 'learning_rate',
                 'epochs', 'gradient_accumulation', 'max_input_dim', 'preprocessing_time',
                 'data_and_model_loading_time', 'training_history', 'training_time',
                 'test_metrics', 'test_time', 'end_time', 'total_time', 'input_duty_cycle')


def _point_pheno_bench(mp, root: str, processed: str) -> None:
    for attr, sub in (('TRAIN_IMG_DIR', 'train/images/'), ('TRAIN_ANNOTATIONS', 'train/semantics/'),
                      ('VAL_IMG_DIR', 'val/images/'), ('VAL_ANNOTATIONS', 'val/semantics/'),
                      ('TEST_IMG_DIR', 'test/images/'), ('TEST_ANNOTATIONS', 'test/semantics/')):
        mp.setattr(pheno_bench, attr, os.path.join(root, sub))
    mp.setattr(pheno_bench, 'PROCESSED_DIR', processed)


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """``engine.train.main()`` on the CPU from the raw fixtures; returns
    (run directory, its metadata, the settings' root)."""
    root = tmp_path_factory.mktemp('trainer')
    rng = np.random.default_rng(0)
    make_pheno_bench(str(root / 'pheno'), rng, n=2)
    make_crop_weed_png(str(root / 'cw'), rng, n=4)
    with pytest.MonkeyPatch.context() as mp, _one_thread():
        for name, value in E2E.items():
            mp.setattr(config, name, value)
        mp.setattr(config, 'MODELS_OUTPUT_DIR', str(root / 'out' / 'models') + '/')
        mp.setattr(config, 'MODEL_CHECKPOINT', str(root / 'no-such-checkpoint'))
        _point_pheno_bench(mp, str(root / 'pheno'), str(root / 'pheno' / 'Processed') + '/')
        mp.setattr(crop_weed, 'IMG_DIR', str(root / 'cw' / 'images') + '/')
        mp.setattr(crop_weed, 'ANNOTATIONS', str(root / 'cw' / 'annotations') + '/')
        mp.setattr(crop_weed, 'PROCESSED_DIR', str(root / 'cw' / 'Processed') + '/')
        mp.setattr(crop_weed, 'TRAIN_VAL_TEST_SPLIT', [0.8, 0.2, 0.0])
        mp.setenv('WISTPU_DEVICE', 'cpu')
        train.main()
    runs = glob.glob(str(root / 'out' / 'models' / 'mask2former_fine_tuned' / '*'))
    assert len(runs) == 1, runs
    with open(os.path.join(runs[0], 'metadata.json')) as f:
        return runs[0], json.load(f), root


def test_train_from_raw_data(trained, monkeypatch):
    """The run's metadata has the JAX trainer's keys (but ``augmentation``,
    written only with ``WISTPU_AUGMENT=1``) and one finite history entry; ``best_model/``,
    ``final_model/`` and ``train_state/`` are written; the cache holds both
    datasets' splits; ``preprocessor_config.json`` equals the one the JAX
    trainer writes under the same settings."""
    run_dir, metadata, root = trained
    for key in METADATA_KEYS:
        assert key in metadata, key
    assert 'augmentation' not in metadata and metadata['epochs'] == 1
    (entry,) = metadata['training_history']
    assert entry['epoch'] == 1 and np.isfinite(entry['train_loss']) and np.isfinite(
        entry['val_loss'])
    assert 'map' in metadata['test_metrics'] and 0.0 < metadata['input_duty_cycle'] <= 1.0
    for sub in ('best_model', 'final_model', 'train_state'):
        assert os.path.isdir(os.path.join(run_dir, sub)), sub
    for name in ('config.json', 'params.npz', 'preprocessor_config.json'):
        assert os.path.exists(os.path.join(run_dir, 'best_model', name)), name
    for name in (ckpt.PARAMS_FILE, ckpt.OPT_STATE_FILE, ckpt.TRAIN_META_FILE):
        assert os.path.exists(os.path.join(run_dir, 'train_state', name)), name
    for split, n in (('Train', 2), ('Validate', 2), ('Test', 2)):
        assert len(glob.glob(str(root / 'pheno' / 'Processed' / split / '*.npz'))) == n
    assert len(glob.glob(str(root / 'cw' / 'Processed' / 'Train' / '*.npz'))) == 1
    assert not os.path.exists(root / 'cw' / 'Processed' / 'Test')

    for name in ('SHORTEST_EDGE', 'LONGEST_EDGE'):
        monkeypatch.setattr(jax_config, name, E2E[name])
    monkeypatch.setattr(jax_config, 'MODEL_CHECKPOINT', str(root / 'no-such-checkpoint'))
    jax_processor = jax_model_utils.default_processor()
    jax_processor.save_pretrained(str(root / 'jax_processor'))
    with open(os.path.join(run_dir, 'best_model', 'preprocessor_config.json')) as f, \
            open(root / 'jax_processor' / 'preprocessor_config.json') as g:
        assert json.load(f) == json.load(g)


def test_checkpoints_and_test_metrics_read_in_jax(trained, monkeypatch):
    """The JAX package loads the port's ``best_model/`` (config, every
    parameter, the processor) and, computing in float32 over the port's
    ``Test`` cache, gets the trainer's ``test_metrics`` within 1e-6; at
    threshold 0.0 too, against the port's ``best_model/`` loaded as the
    trainer's test phase loads it."""
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    run_dir, metadata, root = trained
    cfg, params = jax_ckpt.load_pretrained(os.path.join(run_dir, 'best_model'))
    assert cfg.num_labels == 5 and cfg.id2label[2] == 'weed'
    assert jax_ckpt.load_processor(os.path.join(run_dir, 'best_model')).size == {
        'shortest_edge': 64, 'longest_edge': 96}
    _, final_params = jax_ckpt.load_pretrained(os.path.join(run_dir, 'final_model'))
    assert set(final_params) == set(params)
    test_dirs = [str(root / 'pheno' / 'Processed' / 'Test'), str(root / 'cw' / 'Processed' / 'Test')]
    dataset = jax_dataset_utils.ConcatDataset(
        [jax_dataset_utils.PreprocessedDataset(d) for d in test_dirs])
    loader = JaxDataLoader(dataset, batch_size=2, shuffle=False,
                           collate=jax_dataset_utils.collate_fn)
    want = jax_metrics.prepare_metrics_for_json(jax_metrics.test_with_metrics(
        jax_make_forward_fn(JaxMask2Former(cfg)), params, loader))
    got = metadata['test_metrics']
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)

    # random tiny weights keep no segment at 0.5; at threshold 0.0 every
    # covering slot reaches the IoU product and the matching (map is still 0
    # on the noise images: no prediction reaches IoU 0.5)
    port_loader = DataLoader(dataset_utils.ConcatDataset(
        [dataset_utils.PreprocessedDataset(d) for d in test_dirs]), 2, dataset_utils.collate_fn)
    model = load_test_model(os.path.join(run_dir, 'best_model'), device='cpu')
    got = metrics.test_with_metrics(make_forward_fn(model), port_loader, 0.0, device='cpu')
    want = jax_metrics.test_with_metrics(jax_make_forward_fn(JaxMask2Former(cfg)), params,
                                         loader, 0.0)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)


def _cache_samples(n: int, split: str) -> list:
    """Tiny 64 x 96 samples with two rectangles (labels 1 and 2)."""
    samples = []
    for i in range(n):
        rng = np.random.default_rng(100 * len(split) + i)
        original = np.zeros((64, 96), np.int32)
        y, x = rng.integers(0, 30, size=2)
        original[y:y + 20, x:x + 30], original[40:60, 50:90] = 1, 2
        samples.append({'pixel_values': rng.standard_normal((3, 64, 96)).astype(np.float32),
                        'mask_labels': np.stack([original == 1, original == 2]).astype(np.uint8),
                        'class_labels': np.asarray([1, 2]), 'target_size': (64, 96),
                        'original_map': original, 'id_to_semantic': {1: 1, 2: 2},
                        'file_name': f'{split}_{i:03d}.png'})
    return samples


def _cache_settings(mp, root, epochs: int, resume=None) -> None:
    """pheno_bench from a pre-written cache: 5 training images at batch 1,
    accumulation 2, so an epoch ends mid-cycle."""
    for name, value in (('DATASET_LIST', ['pheno_bench']), ('EPOCHS', epochs), ('BATCH_SIZE', 1),
                        ('GRADIENT_ACCUMULATION', 2), ('MODEL_ARCH', 'tiny-test'),
                        ('REMAT', True), ('RESUME', resume),
                        ('MODEL_CHECKPOINT', str(root / 'no-such-checkpoint'))):
        mp.setattr(config, name, value)
    _point_pheno_bench(mp, str(root / 'raw-absent'), str(root / 'Processed') + '/')


@contextlib.contextmanager
def _one_thread():
    """Tiny shapes run as fast on one thread, and the test workers then do
    not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def resumed_runs(tmp_path_factory):
    """An uninterrupted 2-epoch run (with ``WISTPU_PROFILE`` on), and a
    1-epoch run resumed to 2."""
    root = tmp_path_factory.mktemp('resume')
    for split, n in (('Train', 5), ('Validate', 2), ('Test', 1)):
        dataset_utils.process_and_save(_cache_samples(n, split), str(root / 'Processed' / split))
    runs = {}
    for name, epochs, resume in (('whole', 2, None), ('first', 1, None),
                                 ('resumed', 2, str(root / 'first'))):
        with pytest.MonkeyPatch.context() as mp, _one_thread():
            _cache_settings(mp, root, epochs, resume)
            if name == 'whole':
                mp.setenv('WISTPU_PROFILE', str(root / 'profile'))
            runs[name] = train.train(str(root / name), {}, ['pheno_bench'], device='cpu')
    return root, runs


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_resume_repeats_an_uninterrupted_run(resumed_runs):
    """1 epoch, then ``RESUME`` on to 2, ends with the bits of an
    uninterrupted 2-epoch run: parameters, AdamW moments and step counts,
    the accumulation state, the history and the micro-step count. The
    first run's save falls mid-cycle (5 micro-steps, accumulation 2), so its
    train state carries an unfinished accumulated gradient."""
    root, runs = resumed_runs
    first = _npz(root / 'first' / 'train_state' / ckpt.OPT_STATE_FILE)
    assert int(first['mini_step']) == 1
    assert any(np.abs(v).sum() > 0 for k, v in first.items() if k.startswith('acc_grad/'))
    assert runs['resumed']['resumed_from'] == str(root / 'first' / 'train_state')
    assert [h['epoch'] for h in runs['resumed']['training_history']] == [1, 2]
    assert runs['resumed']['training_history'] == runs['whole']['training_history']
    for name in (ckpt.PARAMS_FILE, ckpt.OPT_STATE_FILE):
        got = _npz(root / 'resumed' / 'train_state' / name)
        want = _npz(root / 'whole' / 'train_state' / name)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with open(root / 'resumed' / 'train_state' / ckpt.TRAIN_META_FILE) as f, \
            open(root / 'whole' / 'train_state' / ckpt.TRAIN_META_FILE) as g:
        got_meta, want_meta = json.load(f), json.load(g)
    assert got_meta == want_meta and want_meta['step'] == 10
    assert int(want['mini_step']) == 0


@pytest.mark.parametrize('fault', ['missing', 'surplus'])
def test_train_state_layout_mismatch_raises(resumed_runs, tmp_path, fault):
    """A train state whose optimizer keys are not the ones this model and
    optimizer write (one dropped, or one added) is refused."""
    root, _ = resumed_runs
    directory = tmp_path / 'train_state'
    shutil.copytree(root / 'first' / 'train_state', directory)
    saved = _npz(directory / ckpt.OPT_STATE_FILE)
    if fault == 'missing':
        saved.pop(next(k for k in saved if k.startswith('exp_avg_sq/')))
    else:
        saved['exp_avg/backbone/extra/kernel'] = np.zeros(3, np.float32)
    np.savez(directory / ckpt.OPT_STATE_FILE, **saved)
    model = build_model('tiny-test', num_labels=5, device='cpu', train=True)
    optimizer = make_optimizer(model.parameters(), 5e-5)
    step = make_train_step(model, model.config, optimizer, 2)
    with pytest.raises(ValueError, match='layout mismatch'):
        ckpt.load_train_checkpoint(str(directory), model, optimizer, step)


@pytest.mark.parametrize('setting', ['DATA_PARALLEL', 'MODEL_PARALLEL', 'WISTPU_AUGMENT'])
def test_parallel_and_augment_settings(trained, tmp_path, monkeypatch, setting):
    """``DATA_PARALLEL`` or ``MODEL_PARALLEL`` of 2 in one process raises
    before anything is written: the mesh needs two processes
    (``tests/test_torch_parallel.py`` runs them). ``WISTPU_AUGMENT=1``
    trains with the augmentation, recorded in the metadata."""
    if setting != 'WISTPU_AUGMENT':
        monkeypatch.setattr(config, setting, 2)
        with pytest.raises(ValueError, match='needs 2 processes; this run has 1'):
            train.train(str(tmp_path / 'run'), {}, ['pheno_bench'], device='cpu')
        assert not os.path.exists(tmp_path / 'run')
        return
    _, _, root = trained
    monkeypatch.setenv('WISTPU_AUGMENT', '1')
    for name, value in E2E.items():
        monkeypatch.setattr(config, name, value)
    monkeypatch.setattr(config, 'DATASET_LIST', ['pheno_bench'])
    monkeypatch.setattr(config, 'MODEL_CHECKPOINT', str(root / 'no-such-checkpoint'))
    _point_pheno_bench(monkeypatch, str(root / 'pheno'), str(root / 'pheno' / 'Processed') + '/')
    with _one_thread():
        metadata = train.train(str(tmp_path / 'run'), {}, ['pheno_bench'], device='cpu')
    assert metadata['augmentation'].startswith('AugmentConfig(')
    (entry,) = metadata['training_history']
    assert np.isfinite(entry['train_loss']) and np.isfinite(entry['val_loss'])
    assert 'map' in metadata['test_metrics']


@pytest.mark.parametrize('labels', ['same count', 'fewer labels'])
def test_build_model_for_labels_from_a_checkpoint(tmp_path, monkeypatch, labels):
    """From a local checkpoint directory (``MODEL_CHECKPOINT``), as the JAX
    ``build_model`` loads one: the labels replaced by the requested ones,
    every weight the checkpoint's, and where the label count differs the
    class head initialised anew at the new size (``ignore_mismatched_sizes``);
    ``default_processor`` reads the directory's processor."""
    source = build_model('tiny-test', num_labels=5, device='cpu', seed=3)
    directory = str(tmp_path / 'ckpt')
    processor = image_processor.Mask2FormerImageProcessor(
        size={'shortest_edge': 64, 'longest_edge': 96})
    ckpt.save_pretrained(directory, source.state_dict(), source.config, processor)
    id2label = ({i: f'c{i}' for i in range(5)} if labels == 'same count'
                else {0: 'crop', 1: 'weed'})
    monkeypatch.setattr(config, 'MODEL_CHECKPOINT', directory)
    model, cfg = build_model_for_labels(id2label, device='cpu', seed=7)
    assert model.training and cfg.id2label == id2label and cfg.num_labels == len(id2label)
    assert cfg.label2id == {v: k for k, v in id2label.items()}
    want = source.state_dict()
    for name, value in model.state_dict().items():
        if name.startswith('class_predictor.') and labels == 'fewer labels':
            assert value.shape[0] == 3 and value.shape[0] != want[name].shape[0]
        else:
            assert torch.equal(value, want[name]), name
    assert default_processor().to_dict() == processor.to_dict()


def test_profile_window(resumed_runs):
    """``WISTPU_PROFILE`` traced micro-steps 3-8 of the uninterrupted run
    (10 micro-steps over 2 epochs) into one trace in the directory, the
    program's spans ranges in it: 5 ``train.micro_step`` ranges, each
    holding its ``forward``, ``criterion`` and ``backward``, and the three
    that end an accumulation cycle of 2 (micro-steps 4, 6 and 8) its
    ``optimizer``. On the CPU the trace holds no device work, so no
    ``device_duty_profiled`` is recorded."""
    root, runs = resumed_runs
    assert sorted(p.name for p in (root / 'profile').iterdir()) == ['trace.json']
    with open(root / 'profile' / 'trace.json') as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    assert 'lap.wait' in {e['name'] for e in events}
    steps = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                   if e['name'] == 'train.micro_step')
    updates = []
    for a, b in steps:
        inside = {e['name'] for e in events if a <= e['ts'] and e['ts'] + e['dur'] <= b}
        assert {'forward', 'criterion', 'backward'} <= inside, (a, b)
        updates.append('optimizer' in inside)
    assert updates == [True, False, True, False, True]
    assert 'device_duty_profiled' not in runs['whole']
