"""The port's inspection entry points against the JAX package's, on the CPU:
``engine/inference.py::run_inference`` on a non-square image whose long
side is resized (float32, and the post-process's class scores at bf16),
``load_ground_truth`` with its edge cases, the per-image mAP ranking of
``engine/show_worst_predictions.py`` over one ``.npz`` cache, and the two
``python -m`` entry points on the fixture datasets. The weights are the JAX
package's seeded-noise tiny-test params carried over by ``params_from_jax``;
the class head's bias favours class 0, so slots pass the 0.5 threshold and
the per-image mAPs differ."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import make_pheno_bench, make_sorghum_weed

from weed_instance_segmentation_tpu import config as jax_config
from weed_instance_segmentation_tpu.datasets.pheno_bench import definitions as jax_pheno_bench
from weed_instance_segmentation_tpu.engine import checkpoint as jax_ckpt
from weed_instance_segmentation_tpu.engine import inference as jax_inference
from weed_instance_segmentation_tpu.engine import show_worst_predictions as jax_worst
from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.engine.steps import make_forward_fn as jax_make_forward_fn
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former
from weed_instance_segmentation_tpu.processing import image_processor as jax_image_processor

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets import dataset_utils
from weed_instance_segmentation_tpu_torch.datasets.pheno_bench import definitions as pheno_bench
from weed_instance_segmentation_tpu_torch.datasets.sorghum_weed import definitions as sorghum
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.engine import inference
from weed_instance_segmentation_tpu_torch.engine import show_worst_predictions as worst
from weed_instance_segmentation_tpu_torch.engine.model_utils import (
    build_model, model_from_state_dict,
)
from weed_instance_segmentation_tpu_torch.engine.steps import make_forward_fn
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax
from weed_instance_segmentation_tpu_torch.processing.image_processor import (
    Mask2FormerImageProcessor,
)
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    post_process_instance_segmentation,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = {'shortest_edge': 64, 'longest_edge': 96}
IMAGE_WH = (150, 97)  # non-square; its long side is cut to MAX_INPUT_DIM
MAX_INPUT_DIM = 120
CLASS_BIAS = [3.0, 0.0, -1.0, 0.0]  # favours class 0 of 3, so slots pass 0.5


@pytest.fixture(scope='module')
def jax_tiny():
    cfg = jax_configuration.Mask2FormerConfig.tiny_test(
        num_labels=3, id2label={0: 'Sorghum', 1: 'BLweed', 2: 'Grass'})
    model = JaxMask2Former(cfg)
    rng = np.random.default_rng(61)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0.0, 0.02, np.shape(x)).astype(np.float32),
        init_params(model, cfg, seed=0, image_hw=(64, 96)))
    params['class_predictor']['bias'] = np.asarray(CLASS_BIAS, np.float32)
    return cfg, params


def _port_model(cfg, params, dtype=torch.float32):
    return model_from_state_dict(Mask2FormerConfig.from_hf_dict(cfg.to_hf_dict()),
                                 params_from_jax(params), dtype, device='cpu')


@pytest.fixture()
def image_path(tmp_path, monkeypatch):
    """A seeded 150 x 97 RGB PNG, with ``MAX_INPUT_DIM`` 120 in both
    packages so the long-side resize runs before the processor's."""
    from PIL import Image

    for cfg in (config, jax_config):
        monkeypatch.setattr(cfg, 'MAX_INPUT_DIM', MAX_INPUT_DIM)
    w, h = IMAGE_WH
    path = str(tmp_path / 'plot.png')
    Image.fromarray(np.random.default_rng(62).integers(0, 256, (h, w, 3), dtype=np.uint8)
                    ).save(path)
    return path


def _assert_results_match(got, want, score_atol):
    """The same ids and labels in order, scores within ``score_atol``, id
    maps of one shape equal on at least 99.9 % of the pixels."""
    assert [(s['id'], s['label_id']) for s in got['segments_info']] == \
        [(s['id'], s['label_id']) for s in want['segments_info']]
    assert got['segments_info']  # the comparison is not empty
    np.testing.assert_allclose([s['score'] for s in got['segments_info']],
                               [s['score'] for s in want['segments_info']], atol=score_atol, rtol=0)
    assert got['segmentation'].shape == want['segmentation'].shape
    assert (got['segmentation'] == want['segmentation']).mean() >= 0.999


def test_run_inference_matches_jax(jax_tiny, image_path):
    """float32: ``run_inference`` of both packages on the same file, each
    with its own forward. The resized images are identical and (W, H)
    (120, 77); the results agree to 1e-5 at that size."""
    cfg, params = jax_tiny
    want_img, want = jax_inference.run_inference(
        image_path, jax_make_forward_fn(JaxMask2Former(cfg)), params,
        jax_image_processor.Mask2FormerImageProcessor(size=SIZE))
    got_img, got = inference.run_inference(
        image_path, make_forward_fn(_port_model(cfg, params)), Mask2FormerImageProcessor(size=SIZE),
        'cpu')
    assert got_img.size == want_img.size == (120, 77)
    np.testing.assert_array_equal(np.asarray(got_img), np.asarray(want_img))
    assert got['segmentation'].shape == (77, 120)
    _assert_results_match(got, want, 1e-5)


def test_run_inference_scores_bf16_as_jax(jax_tiny, image_path):
    """bf16, the inference entry points' compute dtype: the JAX model's class
    logits reach the post-process in bf16, where ``jax.nn.softmax`` runs in
    bf16. The port's post-process, given the same bf16 logits, keeps the same
    slots with the same scores (within 1e-5; a float32 softmax differs by a
    bf16 ulp of the probability, about 2e-3). The port's own
    ``run_inference`` at bf16 hands bf16 logits to its post-process too."""
    cfg, params = jax_tiny
    seen = []
    jax_forward = jax_make_forward_fn(JaxMask2Former(cfg, dtype=jnp.bfloat16))

    def recording(p, pixel_values):
        out = jax_forward(p, pixel_values)
        seen.append(out)
        return out

    img, want = jax_inference.run_inference(
        image_path, recording, params, jax_image_processor.Mask2FormerImageProcessor(size=SIZE))
    out, = seen
    assert out.class_queries_logits.dtype == jnp.bfloat16
    logits = SimpleNamespace(**{
        k: torch.from_numpy(np.asarray(getattr(out, k), np.float32)).bfloat16()
        for k in ('class_queries_logits', 'masks_queries_logits')})
    got = post_process_instance_segmentation(logits, target_sizes=[img.size[::-1]])[0]
    _assert_results_match(got, want, 1e-5)

    port_seen = []
    port_forward = make_forward_fn(_port_model(cfg, params, torch.bfloat16))

    def port_recording(pixel_values):
        port_seen.append(port_forward(pixel_values))
        return port_seen[-1]

    port_img, port = inference.run_inference(image_path, port_recording,
                                             Mask2FormerImageProcessor(size=SIZE), 'cpu')
    assert port_seen[0].class_queries_logits.dtype == torch.bfloat16
    assert port_img.size == img.size and port['segmentation'].shape == (77, 120)


def test_run_inference_array_needs_no_resize_at_the_processor_size(jax_tiny, monkeypatch):
    """An array already at the processor's output size and within
    ``MAX_INPUT_DIM`` goes through unresized: no PIL is called."""
    cfg, params = jax_tiny

    def no_pil(*args):
        raise AssertionError('a resize ran')

    monkeypatch.setattr(inference, 'pil_resize_image', no_pil)
    from weed_instance_segmentation_tpu_torch.processing import image_processor

    monkeypatch.setattr(image_processor, 'pil_resize_image', no_pil)
    image = np.random.default_rng(63).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    resized, res = inference.run_inference_array(
        image, make_forward_fn(_port_model(cfg, params)), Mask2FormerImageProcessor(size=SIZE),
        'cpu')
    assert resized is image and res['segmentation'].shape == (64, 96)


# ---------------------------------------------------------------------------
# load_ground_truth
# ---------------------------------------------------------------------------

GT_CASES = ['scaled', 'missing-original', 'missing-file', 'unparsable', 'no-entry']


@pytest.mark.parametrize('case', GT_CASES)
def test_load_ground_truth_matches_jax(case, tmp_path, capsys):
    """sorghum_weed's VGG-JSON fixture: the polygons scaled from the 128 x 96
    original to (W, H) (200, 130), bit for bit and with equal
    ``segments_info``; the 1:1 scale without the original; ``None`` and the
    same message for a missing or unparsable file or an image with no
    entry."""
    root = str(tmp_path / 'sorghum')
    make_sorghum_weed(root, np.random.default_rng(64), n=2)
    annotations = os.path.join(root, 'Annotations', 'TestSorghumWeed_json.json')
    img_dir = os.path.join(root, 'Test')
    name, target = 'test_001.jpg', (200, 130)
    if case == 'missing-original':
        os.remove(os.path.join(img_dir, name))
        target = (128, 96)
    elif case == 'missing-file':
        annotations += '.missing'
    elif case == 'unparsable':
        with open(annotations, 'w') as f:
            f.write('{"not json')
    elif case == 'no-entry':
        name = 'unknown.jpg'
    args = (os.path.join('some', 'dir', name), target, annotations, img_dir, sorghum.LABEL2ID)
    got = inference.load_ground_truth(*args)
    got_log = capsys.readouterr().out
    want = jax_inference.load_ground_truth(*args)
    assert got_log == capsys.readouterr().out
    if case in ('scaled', 'missing-original'):
        assert got['segmentation'].dtype == want['segmentation'].dtype == np.int32
        assert got['segmentation'].shape == (target[1], target[0])
        np.testing.assert_array_equal(got['segmentation'], want['segmentation'])
        assert got['segments_info'] == want['segments_info'] == [
            {'id': 1, 'label_id': 0, 'score': 1.0}, {'id': 2, 'label_id': 1, 'score': 1.0}]
        assert set(np.unique(got['segmentation'])) == {0, 1, 2}
    else:
        assert got is None and want is None and got_log


# ---------------------------------------------------------------------------
# show_worst_predictions: the per-image mAP ranking
# ---------------------------------------------------------------------------

def _ranking_samples(model, n):
    """Cache samples at one pixel size (64 x 96) and one target size, whose
    ground truth is the model's own kept segments at threshold 0 (every
    other one moved by a few pixels, every third relabelled), so the
    per-image mAPs at threshold 0.5 spread."""
    forward = make_forward_fn(model)
    samples = []
    for i in range(n):
        rng = np.random.default_rng(70 + i)
        pixels = rng.standard_normal((3, 64, 96)).astype(np.float32)
        pred = post_process_instance_segmentation(forward(torch.from_numpy(pixels[None])),
                                                  threshold=0.0, target_sizes=[(128, 192)])[0]
        seg = pred['segmentation'].astype(np.int32)
        original = np.where(seg >= 0, seg + 1, 0).astype(np.int32)
        mapping = {}
        for j, info in enumerate(pred['segments_info']):
            uid = info['id'] + 1
            if (i + j) % 2:
                moved = np.roll(original == uid, int(rng.integers(2, 12)), axis=1)
                original[original == uid] = 0
                original[moved & (original == 0)] = uid
            mapping[uid] = info['label_id'] if (i + j) % 3 else (info['label_id'] + 1) % 3
        original[:4, :4] = 255
        samples.append({'pixel_values': pixels, 'mask_labels': np.zeros((0, 64, 96), np.uint8),
                        'class_labels': np.zeros(0, np.int64), 'target_size': (128, 192),
                        'original_map': original, 'id_to_semantic': mapping,
                        'file_name': f'img_{i:03d}.png'})
    return samples


def test_worst_prediction_ranking_matches_jax(jax_tiny, tmp_path, monkeypatch, capsys):
    """Both packages' ``main()`` on a pheno_bench ``Processed/Test`` cache of
    6 images (a JAX-written checkpoint named through ``latest``; the raw
    test images absent, so nothing is drawn): the same files in the same
    order with per-image mAPs within 1e-6, and the port's
    ``score_images`` gives the whole list."""
    cfg, params = jax_tiny
    run_dir = tmp_path / 'models' / 'mask2former_fine_tuned' / '2026-03-01_10-00-00' / 'best_model'
    jax_ckpt.save_pretrained(str(run_dir), params, cfg,
                             jax_image_processor.Mask2FormerImageProcessor(size=SIZE))
    processed = str(tmp_path / 'Processed') + '/'
    dataset_utils.process_and_save(_ranking_samples(_port_model(cfg, params), 6),
                                   os.path.join(processed, 'Test'))
    for cfg_module, defs in ((config, pheno_bench), (jax_config, jax_pheno_bench)):
        monkeypatch.setattr(cfg_module, 'DATASET_LIST', ['pheno_bench'])
        monkeypatch.setattr(cfg_module, 'MODELS_OUTPUT_DIR', str(tmp_path / 'models') + '/')
        monkeypatch.setattr(cfg_module, 'OUTPUT_DIR', str(tmp_path / 'out') + '/')
        monkeypatch.setattr(defs, 'PROCESSED_DIR', processed)
        monkeypatch.setattr(defs, 'TEST_IMG_DIR', str(tmp_path / 'no-images') + '/')
    model_id = 'mask2former_fine_tuned/latest/best_model/'
    capsys.readouterr()
    got = worst.main(model_id, n_worst=6, show=False, device='cpu')
    port_log = capsys.readouterr().out
    want = jax_worst.main(model_id, n_worst=6, show=False)
    jax_log = capsys.readouterr().out
    assert [c['file_name'] for c in got] == [c['file_name'] for c in want]
    np.testing.assert_allclose([c['score'] for c in got], [c['score'] for c in want],
                               atol=1e-6, rtol=0)
    scores = [c['score'] for c in got]
    assert scores == sorted(scores) and len(set(scores)) >= 3, scores
    assert port_log.count('Image not found') == jax_log.count('Image not found') == 6
    assert '--- Top 6 Worst Predictions (by mAP) ---' in port_log

    port_model = _port_model(cfg, params)
    scored = worst.score_images(make_forward_fn(port_model),
                                dataset_utils.PreprocessedDataset(os.path.join(processed, 'Test')),
                                'cpu')
    assert [(c['file_name'], c['score']) for c in scored] == \
        [(c['file_name'], c['score']) for c in got]
    gt = worst.convert_gt_map_to_result(scored[0]['original_map'], scored[0]['id_mapping'])
    assert gt == jax_worst.convert_gt_map_to_result(scored[0]['original_map'],
                                                    scored[0]['id_mapping'])


# ---------------------------------------------------------------------------
# the python -m entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cli_root(tmp_path_factory):
    """pheno_bench and sorghum_weed fixtures, and a tiny-test port checkpoint
    with its processor under a timestamped run."""
    root = tmp_path_factory.mktemp('cli')
    rng = np.random.default_rng(65)
    make_pheno_bench(str(root / 'pheno'), rng, n=2)
    make_sorghum_weed(str(root / 'sorghum'), rng, n=2)
    model = build_model('tiny-test', num_labels=3, device='cpu', seed=0)
    with torch.no_grad():
        model.class_predictor.bias.copy_(torch.tensor(CLASS_BIAS))
    run = root / 'out' / 'models' / 'mask2former_fine_tuned' / '2026-03-01_10-00-00'
    ckpt.save_pretrained(str(run / 'best_model'), model.state_dict(), model.config,
                         Mask2FormerImageProcessor(size=SIZE))
    return root


def _cli(module, root, out_dir, **extra):
    """Run ``python -m`` of a port module on the fixtures, writing under
    ``out_dir``; the checkpoint is found through ``latest`` where
    ``out_dir`` is the one that holds it."""
    env = dict(os.environ)
    env.update({
        'WISTPU_DEVICE': 'cpu',
        'WISTPU_PHENO_BENCH_ROOT': str(root / 'pheno'),
        'WISTPU_SORGHUM_WEED_ROOT': str(root / 'sorghum'),
        'WISTPU_DATASET_LIST': 'pheno_bench',
        'WISTPU_OUTPUT_DIR': str(out_dir) + '/',
        'WISTPU_MODEL_ID': str(root / 'out' / 'models' / 'mask2former_fine_tuned' / 'latest'
                               / 'best_model'),
        'WISTPU_MAX_INPUT_DIM': str(MAX_INPUT_DIM),
        'WISTPU_N_WORST': '2',
        **extra,
    })
    env.pop('DISPLAY', None)
    proc = subprocess.run([sys.executable, '-m', f'weed_instance_segmentation_tpu_torch.{module}'],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f'{module} failed:\n{proc.stdout}\n{proc.stderr}'
    return proc.stdout


@pytest.mark.parametrize('module', ['inference', 'show_worst_predictions'])
def test_entry_points(cli_root, module):
    """``python -m …engine.inference`` on a pheno_bench test image and
    ``…engine.show_worst_predictions`` over the raw pheno_bench test folder,
    with ``WISTPU_DEVICE=cpu``: the figures are written under the output
    directory."""
    out_dir = cli_root / module
    if module == 'show_worst_predictions':
        out = _cli('engine.show_worst_predictions', cli_root, out_dir)
        assert 'Loading raw test data...' in out and 'Worst Predictions' in out
        assert out.count('Saved visualization') == 2
        assert len(list(out_dir.glob('worst_*_test_00*.png'))) == 2
        return
    image = cli_root / 'pheno' / 'test' / 'images' / 'test_000.png'
    out = _cli('engine.inference', cli_root, out_dir, WISTPU_IMAGE_PATH=str(image))
    assert 'Saved visualization' in out
    assert (out_dir / 'inference.png').exists()


def test_inference_main_beside_ground_truth(cli_root, monkeypatch, capsys):
    """``engine.inference.main`` on a sorghum_weed test image with a ground
    truth: the prediction and the ground truth drawn side by side into
    ``inference.png``; without the annotation file only the prediction."""
    from weed_instance_segmentation_tpu_torch.datasets.sorghum_weed import definitions

    root = cli_root / 'sorghum'
    monkeypatch.setattr(definitions, 'TEST_IMG_DIR', str(root / 'Test') + '/')
    monkeypatch.setattr(definitions, 'TEST_ANNOTATIONS',
                        str(root / 'Annotations' / 'TestSorghumWeed_json.json'))
    monkeypatch.setattr(config, 'DATASET_LIST', ['sorghum_weed'])
    monkeypatch.setattr(config, 'MODELS_OUTPUT_DIR', str(cli_root / 'out' / 'models') + '/')
    monkeypatch.setattr(config, 'OUTPUT_DIR', str(cli_root / 'gt') + '/')
    monkeypatch.delenv('DISPLAY', raising=False)
    image = str(root / 'Test' / 'test_001.jpg')
    res = inference.main('mask2former_fine_tuned/latest/best_model/', image, 'yes',
                         show=False, device='cpu')
    out = capsys.readouterr().out
    assert 'GT annotation' not in out and 'Saved visualization' in out
    assert res['segmentation'].shape == (96, 128) and res['segments_info']
    from PIL import Image

    with Image.open(cli_root / 'gt' / 'inference.png') as im:
        assert im.size == (2000, 1000)  # figsize (20, 10) at 100 dpi: two panels
    monkeypatch.setattr(definitions, 'TEST_ANNOTATIONS', str(root / 'none.json'))
    inference.main('mask2former_fine_tuned/latest/best_model/', image, 'yes', show=False,
                   device='cpu')
    assert 'GT annotation file missing' in capsys.readouterr().out
    assert inference.main('mask2former_fine_tuned/latest/best_model/', image + '.none',
                          show=False, device='cpu') is None
    assert 'Image not found' in capsys.readouterr().out
