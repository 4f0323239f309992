"""The port's evaluation path against the JAX package's, on the CPU: COCO mAP
on the oracle cases of ``tests/test_mean_ap.py``, the HF-style instance
post-process, ``test_with_metrics`` over one ``.npz`` fixture cache, and the
``engine.test`` entry point on a crop_weed-style cache with a JAX-written
checkpoint. Where both sides get the same logits, the results must be equal;
where each side runs its own forward, the tolerance is stated in the test."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_mean_ap import _random_case

from weed_instance_segmentation_tpu import config as jax_config
from weed_instance_segmentation_tpu.datasets import dataset_utils as jax_dataset_utils
from weed_instance_segmentation_tpu.datasets.crop_weed import definitions as jax_crop_weed
from weed_instance_segmentation_tpu.datasets.loader import DataLoader as JaxDataLoader
from weed_instance_segmentation_tpu.engine import checkpoint as jax_ckpt
from weed_instance_segmentation_tpu.engine import metrics as jax_metrics
from weed_instance_segmentation_tpu.engine import test as jax_test
from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.engine.steps import make_forward_fn as jax_make_forward_fn
from weed_instance_segmentation_tpu.evaluation import mean_ap as jax_mean_ap
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former
from weed_instance_segmentation_tpu.processing import postprocess as jax_postprocess
from weed_instance_segmentation_tpu.processing.image_processor import Mask2FormerImageProcessor

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets import dataset_utils
from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions as crop_weed
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader
from weed_instance_segmentation_tpu_torch.engine import metrics
from weed_instance_segmentation_tpu_torch.engine import test as port_test
from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.engine.model_utils import model_from_state_dict
from weed_instance_segmentation_tpu_torch.engine.steps import make_forward_fn
from weed_instance_segmentation_tpu_torch.evaluation.mean_ap import (
    MeanAveragePrecision, mask_iou_matrix,
)
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax
from weed_instance_segmentation_tpu_torch.ops.postprocess_kernel import (
    LAUNCHES as POSTPROCESS_LAUNCHES, upsample_plain,
)
from weed_instance_segmentation_tpu_torch.ops.resize import nearest_indices
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    SCORE_RESOLUTION, post_process_instance_segmentation,
)


# ---------------------------------------------------------------------------
# mAP
# ---------------------------------------------------------------------------

def _oracle_case(name):
    """The inputs of ``tests/test_mean_ap.py``'s oracle tests: the k-th case
    of the randomized sweep, the max-det truncation case, the two
    area-dependent matching cases and the IoU tie case."""
    if name.startswith('sweep-'):
        rng = np.random.default_rng(1234)
        for case in range(int(name.split('-')[1]) + 1):
            n_images = int(rng.integers(1, 6))
            n_classes = int(rng.integers(1, 4))
            quant = 8 if case % 3 == 0 else None
            preds, targets = _random_case(rng, n_images, n_classes, score_quant=quant)
        return preds, targets, case % 4 == 0
    if name == 'max-det':
        rng = np.random.default_rng(7)
        preds, targets = _random_case(rng, 1, 2, max_gt=6, max_dt=0)
        masks = np.zeros((130, 160, 160), bool)
        for i in range(130):
            y, x = int(rng.integers(0, 120)), int(rng.integers(0, 120))
            masks[i, y:y + 30, x:x + 30] = True
        preds[0] = {'masks': masks, 'scores': rng.random(130).astype(np.float32),
                    'labels': rng.integers(0, 2, 130).astype(np.int64)}
        return preds, targets, False
    hw = 160 if name.startswith('area') else 64
    box = lambda y0, y1, x0, x1: np.pad(np.ones((y1 - y0, x1 - x0), bool),  # noqa: E731
                                        ((y0, hw - y1), (x0, hw - x1)))
    if name.startswith('area'):
        targets = [{'masks': np.stack([box(10, 30, 10, 30), box(0, 100, 0, 100)]),
                    'labels': np.asarray([0, 0], np.int64)}]
        dets = [box(5, 95, 5, 95)] + ([box(10, 32, 10, 32)] if name == 'area-2' else [])
    else:  # IoU tie: two identical GTs
        targets = [{'masks': np.stack([box(8, 40, 8, 40)] * 2),
                    'labels': np.asarray([0, 0], np.int64)}]
        dets = [box(8, 40, 8, 36)] * 2
    scores = np.asarray([0.9, 0.8 if name == 'area-2' else 0.7][:len(dets)], np.float32)
    preds = [{'masks': np.stack(dets), 'scores': scores,
              'labels': np.zeros(len(dets), np.int64)}]
    return preds, targets, False


@pytest.mark.parametrize('case', [f'sweep-{k}' for k in range(20)]
                         + ['max-det', 'area-1', 'area-2', 'iou-tie'])
def test_mean_ap_equals_jax(case):
    """Every key of the port's mAP dict equals the JAX package's exactly,
    in value and dtype."""
    preds, targets, class_metrics = _oracle_case(case)
    port = MeanAveragePrecision(iou_type='segm', class_metrics=class_metrics, device='cpu')
    want = jax_mean_ap.MeanAveragePrecision(iou_type='segm', class_metrics=class_metrics)
    port.update(preds, targets)
    want.update(preds, targets)
    got, want = port.compute(), want.compute()
    assert got.keys() == want.keys()
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    port.reset()
    assert port.compute()['map'] == -1.0


def test_mask_iou_matrix_equals_jax():
    """Intersections, areas and IoU bit for bit, with empty sides."""
    rng = np.random.default_rng(31)
    preds = rng.random((7, 40, 52)) < 0.3
    gts = rng.random((5, 40, 52)) < 0.5
    for p, g in ((preds, gts), (preds[:0], gts), (preds, gts[:0])):
        got = mask_iou_matrix(p, g, device='cpu')
        want = jax_mean_ap.mask_iou_matrix(p, g)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# post-process
# ---------------------------------------------------------------------------

TARGET_SIZES = [(500, 700), (384, 384), (100, 150)]  # above, at and below 384²


def _zero_crossings(mask_logits, target_size, margin=1e-5):
    """(H, W) pixels at target size where some query's upsampled logit lies
    within ``margin`` of zero: a bin there may flip between two float32
    summation orders."""
    up = upsample_plain(torch.from_numpy(np.array(mask_logits[None])), SCORE_RESOLUTION)[0]
    near = (up.abs() <= margin).any(dim=0).numpy()
    ys = nearest_indices(SCORE_RESOLUTION[0], target_size[0])
    xs = nearest_indices(SCORE_RESOLUTION[1], target_size[1])
    return near[ys][:, xs]


@pytest.mark.parametrize('binary_maps', [False, True], ids=['id-map', 'binary-maps'])
def test_post_process_instance_segmentation_equals_jax(monkeypatch, binary_maps):
    """The same seeded logits in both packages, one image at each target
    size: ``segments_info`` equal (ids, labels, scores rounded to 6
    decimals); id maps (or binary maps) equal except at zero crossings,
    which are counted (0 at this seed)."""
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    rng = np.random.default_rng(32)
    class_logits = rng.standard_normal((3, 12, 4)).astype(np.float32) * 2
    mask_logits = rng.standard_normal((3, 12, 20, 20)).astype(np.float32) * 2

    class Out:
        def __init__(self, cls, msk):
            self.class_queries_logits, self.masks_queries_logits = cls, msk

    launches = trace.counter(POSTPROCESS_LAUNCHES)
    got = post_process_instance_segmentation(
        Out(torch.from_numpy(class_logits), torch.from_numpy(mask_logits)), threshold=0.3,
        target_sizes=TARGET_SIZES, return_binary_maps=binary_maps)
    assert trace.counter(POSTPROCESS_LAUNCHES) == launches  # CPU tensors: the plain version
    want = jax_postprocess.post_process_instance_segmentation(
        Out(jnp.asarray(class_logits), jnp.asarray(mask_logits)), threshold=0.3,
        target_sizes=TARGET_SIZES, return_binary_maps=binary_maps)
    flips = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g['segments_info'] and g['segments_info'] == w['segments_info'], i
        assert g['segmentation'].dtype == np.float32
        assert g['segmentation'].shape == w['segmentation'].shape
        differ = g['segmentation'] != w['segmentation']
        near = _zero_crossings(mask_logits[i], TARGET_SIZES[i])
        assert not differ[..., ~near].any(), i
        flips += int(differ.sum())
    assert flips == 0


# ---------------------------------------------------------------------------
# test_with_metrics and the engine.test entry point
# ---------------------------------------------------------------------------

def _samples(model, params, n, seed):
    """Seeded cache samples whose ground truth comes from the JAX model's
    own predictions, so the metric is far from 0 and 1: pixel maps of two
    sizes (a ragged batch), originals larger than the input, each kept
    segment of the post-process (threshold 0) as an instance with its
    predicted label, half of them moved by a few pixels, every third with
    the other label, one left out of the mapping, and an ignored (255)
    corner."""
    forward = jax.jit(lambda p, x: model.apply({'params': p}, x, deterministic=True))
    samples = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        hw = (64, 96) if i % 3 else (64, 80)
        target = (2 * hw[0] - 8 * (i % 2), 2 * hw[1])
        pixels = rng.standard_normal((3, *hw)).astype(np.float32)
        out = forward(params, jnp.asarray(pixels[None]))
        pred = jax_postprocess.post_process_instance_segmentation(
            out, threshold=0.0, target_sizes=[target])[0]
        seg = pred['segmentation'].astype(np.int32)
        original = np.where(seg >= 0, seg + 1, 0).astype(np.int32)
        mapping = {}
        for j, info in enumerate(pred['segments_info']):
            uid = info['id'] + 1
            if j % 2:
                shifted = np.roll(original == uid, int(rng.integers(1, 6)), axis=1)
                original[original == uid] = 0
                original[shifted & (original == 0)] = uid
            if j != 1:
                mapping[uid] = info['label_id'] if j % 3 else 1 - info['label_id']
        original[:6, :6] = 255
        samples.append({'pixel_values': pixels,
                        'mask_labels': np.zeros((len(mapping), *hw), np.uint8),
                        'class_labels': np.zeros(len(mapping), np.int64),
                        'target_size': target,
                        'original_map': original,
                        'id_to_semantic': mapping,
                        'file_name': f'img_{i:03d}.png'})
    return samples


@pytest.fixture(scope='module')
def jax_tiny():
    """A tiny-test JAX model with seeded-noise params; the class head's bias
    favours class 0, so slots pass the 0.5 threshold too."""
    cfg = jax_configuration.Mask2FormerConfig.tiny_test(
        num_labels=2, id2label={0: 'crop', 1: 'weed'})
    model = JaxMask2Former(cfg)
    rng = np.random.default_rng(33)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0.0, 0.02, np.shape(x)).astype(np.float32),
        init_params(model, cfg, seed=0, image_hw=(64, 96)))
    params['class_predictor']['bias'] = np.asarray([2.0, 0.0, -1.0], np.float32)
    return cfg, model, params


@pytest.fixture(scope='module')
def cache_dir(jax_tiny, tmp_path_factory):
    _, model, params = jax_tiny
    d = str(tmp_path_factory.mktemp('cache') / 'Test')
    dataset_utils.process_and_save(_samples(model, params, 5, seed=40), d)
    return d


def _jax_loader(d, batch_size=2):
    return JaxDataLoader(jax_dataset_utils.PreprocessedDataset(d), batch_size=batch_size,
                         shuffle=False, collate=jax_dataset_utils.collate_fn)


def _port_loader(d, batch_size=2):
    return DataLoader(dataset_utils.PreprocessedDataset(d), batch_size=batch_size,
                      collate=dataset_utils.collate_fn)


def _assert_metrics_equal(got, want, atol=0.0):
    assert got.keys() == want.keys()
    for key in want:
        if atol:
            np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_collate_fn_equals_jax(cache_dir):
    items = [dataset_utils.PreprocessedDataset(cache_dir)[i] for i in range(3)]
    got, want = dataset_utils.collate_fn(items), jax_dataset_utils.collate_fn(items)
    assert got.keys() == want.keys() and got['pixel_values'].shape == (3, 3, 64, 96)
    np.testing.assert_array_equal(got['pixel_values'], want['pixel_values'])
    for key in ('target_sizes', 'id_mappings', 'file_names'):
        assert got[key] == want[key], key


@pytest.mark.parametrize('threshold', [0.0, 0.5])
def test_with_metrics_equals_jax_on_the_same_logits(jax_tiny, cache_dir, monkeypatch,
                                                     threshold):
    """Both packages' ``test_with_metrics`` over one cache (5 images, batch
    2: a ragged batch and a short last one, which the port runs at its own
    size and the JAX package pads), the port fed the JAX forward's logits:
    every key of the mAP dict equal. At threshold 0.0 every covering
    slot reaches the matching."""
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    cfg, model, params = jax_tiny
    jax_forward = jax_make_forward_fn(model)
    rows = []

    def forward(pixel_values):
        rows.append(pixel_values.shape[0])
        out = jax_forward(params, jnp.asarray(pixel_values.numpy()))
        return SimpleNamespace(
            class_queries_logits=torch.from_numpy(np.array(out.class_queries_logits)),
            masks_queries_logits=torch.from_numpy(np.array(out.masks_queries_logits)))

    got = metrics.test_with_metrics(forward, _port_loader(cache_dir), threshold, device='cpu')
    want = jax_metrics.test_with_metrics(jax_forward, params, _jax_loader(cache_dir), threshold)
    assert rows == [2, 2, 1]  # the short last batch runs at its own size
    assert 0.01 < got['map'] < 0.95 and len(got['classes']) == 2
    _assert_metrics_equal(got, want)


def _record_post_process(monkeypatch):
    """Wrap both packages' ``post_process_instance_segmentation`` as their
    metric loops call it: each image's id map and its final mask logits,
    per package, in call order."""
    seen = {'port': [], 'jax': []}
    for name, module in (('port', metrics), ('jax', jax_metrics)):
        def recording(outputs, *args, fn=module.post_process_instance_segmentation,
                      into=seen[name], **kwargs):
            out = fn(outputs, *args, **kwargs)
            logits = np.asarray(outputs.masks_queries_logits, np.float32)
            into.extend(zip((p['segmentation'] for p in out), logits,
                            kwargs['target_sizes']))
            return out
        monkeypatch.setattr(module, 'post_process_instance_segmentation', recording)
    return seen


def _count_flips(seen):
    """Id-map pixels that differ between the packages; each must lie where
    some query's upsampled logit is within the two forwards' largest logit
    difference (plus 1e-5) of zero, a bin that float32 rounding may move."""
    assert len(seen['port']) == len(seen['jax']) > 0
    flips = 0
    for (seg, logits, size), (want_seg, want_logits, _) in zip(seen['port'], seen['jax']):
        margin = float(np.abs(logits - want_logits).max()) + 1e-5
        differ = seg != want_seg
        assert not differ[~_zero_crossings(want_logits, tuple(size), margin)].any()
        flips += int(differ.sum())
    return flips


def test_with_metrics_equals_jax_with_each_forward(jax_tiny, cache_dir, monkeypatch):
    """The same, each package running its own tiny-test forward in float32
    (weights carried over by ``params_from_jax``) at threshold 0.0. The
    logits differ by float32 rounding (below 5e-4, the port's model-test
    tolerance), which may move a bin at a zero crossing: the id maps differ
    only there, and the flipped pixels are counted (0 at this seed); every
    key is equal within 1e-6."""
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    seen = _record_post_process(monkeypatch)
    cfg, model, params = jax_tiny
    port_model = model_from_state_dict(Mask2FormerConfig.from_hf_dict(cfg.to_hf_dict()),
                                       params_from_jax(params), device='cpu')
    got = metrics.test_with_metrics(make_forward_fn(port_model), _port_loader(cache_dir), 0.0,
                                    device='cpu')
    want = jax_metrics.test_with_metrics(jax_make_forward_fn(model), params,
                                         _jax_loader(cache_dir), 0.0)
    assert _count_flips(seen) == 0
    _assert_metrics_equal(got, want, atol=1e-6)


def test_metrics_helpers_equal_jax(cache_dir, capsys):
    ds = dataset_utils.PreprocessedDataset(cache_dir)
    items = [ds[i] for i in range(len(ds))]
    maps, mappings = [it['original_map'] for it in items], [it['id_to_semantic'] for it in items]
    got = metrics.targets_from_original_maps(maps, mappings)
    want = jax_metrics.targets_from_original_maps(maps, mappings)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g['masks'], w['masks'])
        np.testing.assert_array_equal(g['labels'], w['labels'])
    result = {'map': np.float32(0.25), 'map_50': np.float32(0.5), 'map_75': np.float32(-1.0),
              'classes': np.asarray([0, 1], np.int32)}
    assert metrics.prepare_metrics_for_json(result) == jax_metrics.prepare_metrics_for_json(result)
    assert metrics.prepare_metrics_for_json({}) is None
    for fn in (metrics.print_metrics_evaluation, jax_metrics.print_metrics_evaluation):
        fn(result, 'M')
    out = capsys.readouterr().out.split('\n--- M Metrics ---')
    assert len(out) == 3 and out[1] == out[2]


def _test_model_both(jax_tiny, tmp_path, monkeypatch):
    """``engine.test.test_model`` of both packages on a crop_weed-style cache
    (``<PROCESSED_DIR>/Test``), the checkpoint written by the JAX package
    under a timestamped run and named through ``latest``; returns the port's
    and the JAX package's metric dicts and the recorded post-processes."""
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    seen = _record_post_process(monkeypatch)
    cfg, model, params = jax_tiny
    run_dir = tmp_path / 'models' / 'mask2former_fine_tuned' / '2026-03-01_10-00-00' / 'best_model'
    jax_ckpt.save_pretrained(str(run_dir), params, cfg,
                             Mask2FormerImageProcessor(size={'shortest_edge': 64,
                                                             'longest_edge': 96}))
    processed = str(tmp_path / 'Processed') + '/'
    dataset_utils.process_and_save(_samples(model, params, 3, seed=50),
                                   os.path.join(processed, 'Test'))
    for cfg_module, defs in ((config, crop_weed), (jax_config, jax_crop_weed)):
        monkeypatch.setattr(cfg_module, 'DATASET_LIST', ['crop_weed'])
        monkeypatch.setattr(cfg_module, 'MODELS_OUTPUT_DIR', str(tmp_path / 'models') + '/')
        monkeypatch.setattr(cfg_module, 'BATCH_SIZE', 2)
        monkeypatch.setattr(defs, 'PROCESSED_DIR', processed)
    monkeypatch.setattr(jax_config, 'DATA_PARALLEL', 1)
    model_id = 'mask2former_fine_tuned/latest/best_model/'
    got = port_test.test_model(model_id, device='cpu')
    want = jax_test.test_model(model_id)
    return got, want, seen


def test_test_model_equals_jax(jax_tiny, tmp_path, monkeypatch):
    """``engine.test.test_model`` in both packages on a crop_weed-style cache,
    each running its own forward (float32, threshold 0.5); the id maps differ
    only at counted zero crossings (0 at this seed) and every key is equal
    within 1e-6."""
    got, want, seen = _test_model_both(jax_tiny, tmp_path, monkeypatch)
    assert 0.01 < got['map'] < 0.95
    assert _count_flips(seen) == 0
    _assert_metrics_equal(got, want, atol=1e-6)

    model_id = 'mask2former_fine_tuned/latest/best_model/'
    assert port_test.test_model('mask2former_fine_tuned/none/best_model/', device='cpu') is None
    monkeypatch.setattr(crop_weed, 'PROCESSED_DIR', str(tmp_path / 'nowhere') + '/')
    assert port_test.test_model(model_id, device='cpu') is None


def test_test_model_computes_in_float32_at_bf16(jax_tiny, tmp_path, monkeypatch):
    """With ``COMPUTE_DTYPE = 'bfloat16'`` in both packages, ``engine.test``
    still builds its model in float32, as the JAX entry point does
    (``Mask2Former(cfg)`` at its default dtype): the same result as
    :func:`test_test_model_equals_jax`, at its tolerance."""
    for cfg_module in (config, jax_config):
        monkeypatch.setattr(cfg_module, 'COMPUTE_DTYPE', 'bfloat16')
    got, want, seen = _test_model_both(jax_tiny, tmp_path, monkeypatch)
    assert 0.01 < got['map'] < 0.95
    assert _count_flips(seen) == 0
    _assert_metrics_equal(got, want, atol=1e-6)
