"""The port's raw-data path against the JAX package's on the CPU: the four
dataset readers on the synthetic fixtures of ``tests/fixtures.py``, the host
raster ops (through the C++ library and through the fallback), the image
processor, the dataset helpers, the cache writer ``datasets.preprocess``,
and the raw route of ``engine.test``. Both sides read the same files, so
every array must be equal bit for bit."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from fixtures import make_crop_weed_png, make_crop_weed_yaml, make_pheno_bench, make_sorghum_weed

from weed_instance_segmentation_tpu import config as jax_config
from weed_instance_segmentation_tpu.datasets import dataset_utils as jax_dataset_utils
from weed_instance_segmentation_tpu.datasets import factory as jax_factory
from weed_instance_segmentation_tpu.datasets import preprocess as jax_preprocess
from weed_instance_segmentation_tpu.datasets.crop_weed import definitions as jax_crop_weed
from weed_instance_segmentation_tpu.datasets.loader import DataLoader as JaxDataLoader
from weed_instance_segmentation_tpu.datasets.pheno_bench import definitions as jax_pheno_bench
from weed_instance_segmentation_tpu.engine import checkpoint as jax_ckpt
from weed_instance_segmentation_tpu.engine import test as jax_test
from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former
from weed_instance_segmentation_tpu.ops import rasterize as jax_rasterize
from weed_instance_segmentation_tpu.processing import image_processor as jax_image_processor

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets import dataset_utils, factory, preprocess
from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions as crop_weed
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader
from weed_instance_segmentation_tpu_torch.datasets.pheno_bench import definitions as pheno_bench
from weed_instance_segmentation_tpu_torch.engine import test as port_test
from weed_instance_segmentation_tpu_torch.ops import rasterize
from weed_instance_segmentation_tpu_torch.processing import image_processor

SMALL = dict(size={'shortest_edge': 96, 'longest_edge': 160})
SAMPLE_KEYS = {'pixel_values', 'mask_labels', 'class_labels', 'target_size', 'original_map',
               'id_to_semantic', 'file_name'}

# reader → (fixture maker, JAX module, port module, image folder, annotations, label2id)
_CW = 'crop_weed.annotation_dependent_implementations.dataset_from_'
READERS = {
    'pheno_bench': (make_pheno_bench, 'pheno_bench.dataset', 'train/images', 'train/semantics',
                    {'background': 0, 'crop': 1, 'weed': 2}),
    'sorghum_weed': (make_sorghum_weed, 'sorghum_weed.dataset', 'Train',
                     'Annotations/TrainSorghumWeed_json.json',
                     {'Sorghum': 0, 'BLweed': 1, 'Grass': 2}),
    'crop_weed_png': (make_crop_weed_png, _CW + 'png_annotations', 'images', 'annotations',
                      {'crop': 0, 'weed': 1}),
    'crop_weed_yaml': (make_crop_weed_yaml, _CW + 'yaml_annotations', 'images', 'annotations',
                       {'crop': 0, 'weed': 1}),
}


def _reader_class(package: str, module: str):
    mod = __import__(f'{package}.datasets.{module}', fromlist=['_'])
    return next(getattr(mod, n) for n in dir(mod)
                if n.endswith('Dataset') and n != 'WeedInstanceDataset'
                and getattr(mod, n).__module__ == mod.__name__)


def _assert_samples_equal(got: dict, want: dict):
    assert set(got) == set(want) == SAMPLE_KEYS
    for key in ('pixel_values', 'mask_labels', 'class_labels', 'original_map'):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ('target_size', 'id_to_semantic', 'file_name'):
        assert got[key] == want[key], key


@pytest.mark.parametrize('limits', ['defaults', 'max_images_and_dim'])
@pytest.mark.parametrize('reader', list(READERS))
def test_reader_equals_jax(tmp_path, monkeypatch, reader, limits):
    """Each reader gives the JAX reader's samples, every key of every sample
    bit for bit; with MAX_IMAGES 2 and MAX_INPUT_DIM 100 (a long-side resize
    of the 96 x 128 fixtures, polygon coordinates scaled) both keep and
    resize the same way."""
    make, module, images, annotations, label2id = READERS[reader]
    make(str(tmp_path), np.random.default_rng(5))
    if limits != 'defaults':
        for cfg in (config, jax_config):
            monkeypatch.setattr(cfg, 'MAX_IMAGES', 2)
            monkeypatch.setattr(cfg, 'MAX_INPUT_DIM', 100)
    datasets = []
    for package, proc in (('weed_instance_segmentation_tpu_torch', image_processor),
                          ('weed_instance_segmentation_tpu', jax_image_processor)):
        cls = _reader_class(package, module)
        datasets.append(cls(image_folder_path=os.path.join(tmp_path, images),
                            annotation_path=os.path.join(tmp_path, annotations),
                            processor=proc.Mask2FormerImageProcessor(**SMALL), label2id=label2id))
    got, want = datasets
    assert len(got) == len(want) == (2 if limits != 'defaults' else len(want)) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        _assert_samples_equal(g, w)
        assert g['mask_labels'].shape[0] >= 2
        if limits != 'defaults':
            assert max(g['target_size']) == 100


@pytest.mark.parametrize('backend', ['native', 'fallback'])
def test_raster_ops_equal_jax(monkeypatch, backend):
    """``connected_components``, ``fill_poly`` and ``color_match`` of both
    packages on random masks, polygons and colour maps, through the C++
    library and through the numpy/scipy/PIL fallback."""
    if backend == 'fallback':
        monkeypatch.setattr(rasterize, '_load_native', lambda: None)
        monkeypatch.setattr(jax_rasterize, '_load_native', lambda: None)
    else:
        assert rasterize.native_available() and jax_rasterize.native_available()
    rng = np.random.default_rng(11)
    for _ in range(4):
        mask = (rng.random((40, 57)) < 0.45).astype(np.uint8)
        n, labels = rasterize.connected_components(mask)
        want_n, want_labels = jax_rasterize.connected_components(mask)
        assert n == want_n > 2
        np.testing.assert_array_equal(labels, want_labels)
    assert rasterize.connected_components(np.zeros((5, 6), np.uint8))[0] == 1
    for _ in range(4):
        points = np.stack([rng.integers(-5, 70, 6), rng.integers(-5, 50, 6)], axis=1)
        got = rasterize.fill_poly(np.full((45, 64), 255, np.int32), points, 7)
        want = jax_rasterize.fill_poly(np.full((45, 64), 255, np.int32), points, 7)
        np.testing.assert_array_equal(got, want)
        assert (got == 7).any()
    rgb = rng.choice(np.asarray([[0, 255, 0], [255, 0, 0], [0, 0, 0], [255, 255, 0]], np.uint8),
                     size=(30, 41))
    for color in ((0, 255, 0), (255, 0, 0)):
        np.testing.assert_array_equal(rasterize.color_match(rgb, color),
                                      jax_rasterize.color_match(rgb, color))


def _image_and_map(rng, h, w):
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    seg = np.full((h, w), 255, np.int32)
    mapping = {}
    for i in range(1, 5):
        y, x = int(rng.integers(0, h - 12)), int(rng.integers(0, w - 12))
        seg[y:y + 10, x:x + 12] = i
        mapping[i] = int(rng.integers(0, 3))
    return image, seg, mapping


@pytest.mark.parametrize('kwargs', [{}, SMALL, dict(size={'shortest_edge': 64,
                                                         'longest_edge': 96}, size_divisor=0)],
                         ids=['defaults', 'small', 'no-divisor'])
def test_image_processor_equals_jax(tmp_path, kwargs):
    """The processor's outputs (two images of different sizes, a batch pad,
    maps with instance mappings) and ``to_dict()`` equal the JAX package's;
    a ``preprocessor_config.json`` written by either loads in the other."""
    rng = np.random.default_rng(3)
    (im1, seg1, map1), (im2, seg2, map2) = _image_and_map(rng, 90, 130), _image_and_map(rng, 70, 61)
    got_proc = image_processor.Mask2FormerImageProcessor(**kwargs)
    want_proc = jax_image_processor.Mask2FormerImageProcessor(**kwargs)
    assert got_proc.to_dict() == want_proc.to_dict()
    args = dict(images=[im1, im2], segmentation_maps=[seg1, seg2],
                instance_id_to_semantic_id=[map1, map2], ignore_index=255)
    got, want = got_proc(**args), want_proc(**args)
    assert got.keys() == want.keys()
    for key in ('pixel_values', 'pixel_mask'):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    for key in ('mask_labels', 'class_labels'):
        for g, w in zip(got[key], want[key], strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    pt = got_proc(images=[im1], return_tensors='pt')
    assert isinstance(pt['pixel_values'], torch.Tensor)
    np.testing.assert_array_equal(pt['pixel_values'].numpy(),
                                  want_proc(images=[im1])['pixel_values'])

    got_proc.save_pretrained(str(tmp_path / 'port'))
    want_proc.save_pretrained(str(tmp_path / 'jax'))
    assert (jax_image_processor.Mask2FormerImageProcessor.from_pretrained(
        str(tmp_path / 'port')).to_dict() == want_proc.to_dict())
    assert (image_processor.Mask2FormerImageProcessor.from_pretrained(
        str(tmp_path / 'jax')).to_dict() == got_proc.to_dict())
    with open(tmp_path / 'port' / 'preprocessor_config.json') as f, \
            open(tmp_path / 'jax' / 'preprocessor_config.json') as g:
        assert json.load(f) == json.load(g)


def test_dataset_helpers_equal_jax():
    """``split_lengths`` (the remainder rule), ``seeded_permutation``,
    ``ConcatDataset``/``Subset`` indexing, the loader's epoch orders with
    ``set_epoch``, and the factory's lookups."""
    for total in (0, 1, 5, 7, 10, 23):
        for ratios in ([0.8, 0.2, 0.0], [0.6, 0.2, 0.2], [0.7, 0.3, 0.0], [1.0, 0.0, 0.0]):
            assert (preprocess.split_lengths(total, ratios)
                    == jax_preprocess.split_lengths(total, ratios))
    for n in (1, 5, 17):
        assert preprocess.seeded_permutation(n) == jax_preprocess.seeded_permutation(n)

    parts = [list(range(3)), list(range(10, 12)), [], list(range(20, 24))]
    got = dataset_utils.ConcatDataset(parts)
    want = jax_dataset_utils.ConcatDataset(parts)
    assert len(got) == len(want) == 9
    assert [got[i] for i in range(-9, 9)] == [want[i] for i in range(-9, 9)]
    sub, jax_sub = dataset_utils.Subset(got, [8, 0, 4]), jax_dataset_utils.Subset(want, [8, 0, 4])
    assert len(sub) == 3 and [sub[i] for i in range(3)] == [jax_sub[i] for i in range(3)]

    items = [{'i': i} for i in range(7)]

    def orders(loader, epochs):
        return [[b['i'] for b in loader] for _ in range(epochs)]

    def collate(batch):
        return {'i': [x['i'] for x in batch]}

    port = DataLoader(items, 3, collate, shuffle=True)
    jax_loader = JaxDataLoader(items, 3, shuffle=True, collate=collate)
    assert orders(port, 3) == orders(jax_loader, 3)
    port.set_epoch(1)
    jax_loader.set_epoch(1)
    assert orders(port, 2) == orders(jax_loader, 2)

    for name in ('pheno_bench', 'sorghum_weed', 'crop_weed'):
        cls, defs = factory.get_dataset_and_config(name)
        want_cls, want_defs = jax_factory.get_dataset_and_config(name)
        assert cls.__name__ == want_cls.__name__ and defs.ID2LABEL == want_defs.ID2LABEL
        assert cls.__module__.startswith('weed_instance_segmentation_tpu_torch.')
    with pytest.raises(ValueError):
        factory.get_dataset_and_config('no_such_dataset')


def _point_definitions(monkeypatch, name: str, src: str, processed: str, split=None):
    """Point both packages' definitions of ``name`` at the raw fixture in
    ``src`` and at the package's own ``processed`` directory."""
    for defs, out in ((pheno_bench if name == 'pheno_bench' else crop_weed, processed + '/port/'),
                      (jax_pheno_bench if name == 'pheno_bench' else jax_crop_weed,
                       processed + '/jax/')):
        monkeypatch.setattr(defs, 'PROCESSED_DIR', out)
        if name == 'pheno_bench':
            for attr, sub in (('TRAIN_IMG_DIR', 'train/images/'),
                              ('TRAIN_ANNOTATIONS', 'train/semantics/'),
                              ('VAL_IMG_DIR', 'val/images/'), ('VAL_ANNOTATIONS', 'val/semantics/'),
                              ('TEST_IMG_DIR', 'test/images/'),
                              ('TEST_ANNOTATIONS', 'test/semantics/')):
                monkeypatch.setattr(defs, attr, os.path.join(src, sub))
        else:
            monkeypatch.setattr(defs, 'IMG_DIR', os.path.join(src, 'images/'))
            monkeypatch.setattr(defs, 'ANNOTATIONS', os.path.join(src, 'annotations/'))
            monkeypatch.setattr(defs, 'TRAIN_VAL_TEST_SPLIT', split)


@pytest.mark.parametrize('name', ['pheno_bench', 'crop_weed'])
def test_preprocess_writes_the_jax_cache(tmp_path, monkeypatch, name):
    """``datasets.preprocess`` of both packages over the same raw fixture
    (pheno_bench's predefined splits; crop_weed's seeded 0.6/0.2/0.2 split of
    7 images, the remainder rule in play): the same files, each ``.npz``
    holding the same arrays bit for bit, and the same ``_shapes.json``; a
    second call finds the cache and does nothing."""
    src = str(tmp_path / 'raw')
    if name == 'pheno_bench':
        make_pheno_bench(src, np.random.default_rng(8), n=3)
    else:
        make_crop_weed_png(src, np.random.default_rng(8), n=7)
    _point_definitions(monkeypatch, name, src, str(tmp_path / 'out'), [0.6, 0.2, 0.2])
    for module, cfg, proc in ((preprocess, config, image_processor),
                              (jax_preprocess, jax_config, jax_image_processor)):
        monkeypatch.setattr(cfg, 'MODEL_CHECKPOINT', str(tmp_path / 'none'))
        assert module.preprocess_dataset(name, proc.Mask2FormerImageProcessor(**SMALL)) is True
        assert module.preprocess_dataset(name, proc.Mask2FormerImageProcessor(**SMALL)) is False

    root = tmp_path / 'out'
    files = sorted(os.path.relpath(p, root / 'jax') for p in glob.glob(str(root / 'jax/*/*')))
    assert files == sorted(os.path.relpath(p, root / 'port')
                           for p in glob.glob(str(root / 'port/*/*')))
    splits = {f.split('/')[0] for f in files}
    assert splits == {'Train', 'Validate', 'Test'}
    if name == 'crop_weed':
        counts = {s: sum(f.startswith(s + '/') and f.endswith('.npz') for f in files)
                  for s in splits}
        assert counts == {'Train': 4, 'Validate': 1, 'Test': 2}
    for f in files:
        if f.endswith('.json'):
            assert json.load(open(root / 'port' / f)) == json.load(open(root / 'jax' / f)), f
            continue
        with np.load(root / 'port' / f) as got, np.load(root / 'jax' / f) as want:
            assert got.files == want.files, f
            for key in want.files:
                assert got[key].dtype == want[key].dtype, (f, key)
                np.testing.assert_array_equal(got[key], want[key], err_msg=f'{f} {key}')


def test_test_model_raw_route_equals_jax(tmp_path, monkeypatch):
    """``engine.test`` of both packages on pheno_bench, which has a test
    folder: both read the raw images through the checkpoint's processor
    (written by the JAX package with the model), each runs its own float32
    forward, and the metric dicts agree within 1e-6."""
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    src = str(tmp_path / 'raw')
    make_pheno_bench(src, np.random.default_rng(9), n=3)
    _point_definitions(monkeypatch, 'pheno_bench', src, str(tmp_path / 'out'))
    cfg = jax_configuration.Mask2FormerConfig.tiny_test(
        num_labels=5, id2label=jax_pheno_bench.ID2LABEL)
    params = init_params(JaxMask2Former(cfg), cfg, seed=0, image_hw=(64, 96))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    params['class_predictor']['bias'] = np.asarray([0.0, 3.0, 2.0, -1.0, -1.0, 0.0], np.float32)
    run = tmp_path / 'models' / 'mask2former_fine_tuned' / '2026-04-01_00-00-00' / 'best_model'
    jax_ckpt.save_pretrained(str(run), params, cfg, jax_image_processor.Mask2FormerImageProcessor(
        size={'shortest_edge': 64, 'longest_edge': 96}))
    for cfg_module in (config, jax_config):
        monkeypatch.setattr(cfg_module, 'DATASET_LIST', ['pheno_bench'])
        monkeypatch.setattr(cfg_module, 'MODELS_OUTPUT_DIR', str(tmp_path / 'models') + '/')
        monkeypatch.setattr(cfg_module, 'BATCH_SIZE', 2)
    monkeypatch.setattr(jax_config, 'DATA_PARALLEL', 1)
    model_id = 'mask2former_fine_tuned/latest/best_model/'
    got = port_test.test_model(model_id, device='cpu')
    want = jax_test.test_model(model_id)
    assert not os.path.exists(tmp_path / 'out')  # the raw route writes no cache
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)
