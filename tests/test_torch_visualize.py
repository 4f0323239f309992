"""The port's drawing code against the JAX package's, on the CPU:
``plot_segmentation`` on one image and result dict (the same canvas pixels),
and each dataset's ground-truth viewer on the fixtures of
``tests/test_visualize.py`` (the same saved PNG pixels)."""

import glob
import os

import numpy as np
import pytest

from fixtures import make_crop_weed_png, make_crop_weed_yaml, make_pheno_bench, make_sorghum_weed

from weed_instance_segmentation_tpu import config as jax_config
from weed_instance_segmentation_tpu.engine import model_utils as jax_model_utils

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.engine import model_utils


@pytest.fixture()
def no_display(monkeypatch):
    monkeypatch.delenv('DISPLAY', raising=False)


def _result(rng, n, hw=(97, 150)):
    """An id map of ``n`` overlapping rectangles (ids 0..n-1, -1 background)
    with labels of 3 classes and scores around the 0.5 cut."""
    seg = np.full(hw, -1, np.float32)
    info = []
    for i in range(n):
        y, x = rng.integers(0, hw[0] - 12), rng.integers(0, hw[1] - 12)
        h, w = rng.integers(6, 30, size=2)
        seg[y:y + h, x:x + w] = i
        info.append({'id': i, 'label_id': int(rng.integers(0, 3)), 'was_fused': False,
                     'score': round(float(rng.uniform(0.4, 1.0)), 6)})
    return {'segmentation': seg, 'segments_info': info}


def _canvas(module, image, result, **kwargs):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    module.plot_segmentation(image, result, {0: 'crop', 1: 'weed'}, ax=ax, show=False, **kwargs)
    fig.canvas.draw()
    pixels = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return pixels


@pytest.mark.parametrize('n, by_class', [(7, False), (7, True), (26, False)],
                         ids=['tab20', 'tab20-by-class', 'nipy-spectral'])
def test_plot_segmentation_matches_jax(no_display, n, by_class):
    """Up to 20 instances (tab20) and more (nipy_spectral), coloured by
    instance or by class, a label missing from ``id2label`` and segments
    below the score cut: the same pixels from both packages."""
    rng = np.random.default_rng(n)
    image = rng.integers(0, 256, (97, 150, 3), dtype=np.uint8)
    result = _result(rng, n)
    got = _canvas(model_utils, image, result, color_by_class=by_class)
    want = _canvas(jax_model_utils, image, result, color_by_class=by_class)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    blank = _canvas(model_utils, image, {'segmentation': result['segmentation'],
                                         'segments_info': []})
    assert (blank != got).any()  # the instances were drawn


def _viewer(name):
    """(port module, JAX module) of a dataset viewer."""
    import importlib

    path = {
        'pheno_bench': 'datasets.pheno_bench.visualize',
        'sorghum_weed': 'datasets.sorghum_weed.visualize',
        'crop_weed_png': 'datasets.crop_weed.annotation_dependent_implementations.'
                         'visualize_png_annotations',
        'crop_weed_yaml': 'datasets.crop_weed.annotation_dependent_implementations.'
                          'visualize_yaml_annotations',
    }[name]
    return (importlib.import_module(f'weed_instance_segmentation_tpu_torch.{path}'),
            importlib.import_module(f'weed_instance_segmentation_tpu.{path}'))


def _viewer_args(name, root):
    rng = np.random.default_rng(0)
    if name == 'pheno_bench':
        make_pheno_bench(root, rng, n=2)
        return os.path.join(root, 'train/images'), os.path.join(root, 'train/semantics')
    if name == 'sorghum_weed':
        make_sorghum_weed(root, rng, n=2)
        return (os.path.join(root, 'Train'),
                os.path.join(root, 'Annotations', 'TrainSorghumWeed_json.json'))
    (make_crop_weed_png if name == 'crop_weed_png' else make_crop_weed_yaml)(root, rng, n=3)
    return os.path.join(root, 'images'), os.path.join(root, 'annotations')


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert('RGBA'))


@pytest.mark.parametrize('name', ['pheno_bench', 'sorghum_weed', 'crop_weed_png',
                                  'crop_weed_yaml'])
def test_visualizer_matches_jax(name, tmp_path, monkeypatch, no_display, capsys):
    """Each viewer over its fixture with ``MAX_IMAGES`` 2: the same count,
    messages and file names as the JAX viewer, and the same pixels in every
    saved PNG."""
    port, jax_viewer = _viewer(name)
    args = _viewer_args(name, str(tmp_path / 'data'))
    outs = {}
    for cfg, which in ((config, 'port'), (jax_config, 'jax')):
        monkeypatch.setattr(cfg, 'OUTPUT_DIR', str(tmp_path / which) + '/')
        monkeypatch.setattr(cfg, 'MAX_IMAGES', 2)
    capsys.readouterr()
    assert port.visualize_dataset(*args, show=False) == 2
    port_log = capsys.readouterr().out
    assert jax_viewer.visualize_dataset(*args, show=False) == 2
    jax_log = capsys.readouterr().out
    assert port_log.replace(str(tmp_path / 'port'), '') == jax_log.replace(str(tmp_path / 'jax'), '')
    for which in ('port', 'jax'):
        outs[which] = sorted(glob.glob(str(tmp_path / which / 'visualizations' / '*.png')))
    assert [os.path.basename(p) for p in outs['port']] == \
        [os.path.basename(p) for p in outs['jax']] and len(outs['port']) == 2
    for got, want in zip(outs['port'], outs['jax']):
        np.testing.assert_array_equal(_pixels(got), _pixels(want))

    missing = str(tmp_path / 'no-annotations')
    assert port.visualize_dataset(args[0], missing, show=False) == 0
    assert 'not found' in capsys.readouterr().out


def test_crop_weed_viewer_dispatch():
    """The crop_weed viewer is the PNG one under the default format, as in
    the JAX package."""
    from weed_instance_segmentation_tpu.datasets.crop_weed import visualize as jax_visualize
    from weed_instance_segmentation_tpu_torch.datasets.crop_weed import visualize
    from weed_instance_segmentation_tpu_torch.datasets.crop_weed.annotation_dependent_implementations import (  # noqa: E501
        visualize_png_annotations,
    )

    assert visualize.visualize_dataset is visualize_png_annotations.visualize_dataset
    assert jax_visualize.visualize_dataset.__name__ == visualize.visualize_dataset.__name__
