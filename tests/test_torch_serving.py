"""The port's serving slice end to end (uint8 → pre-process → forward →
post-process) against the JAX package's ``make_serving_fn`` at tiny-test,
float32, on the CPU; and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weed_instance_segmentation_tpu.engine.export import make_serving_fn as jax_make_serving_fn
from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former

from weed_instance_segmentation_tpu_torch.engine.export import make_serving_fn
from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax
from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2Former

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2x upscale: the pre-process weights are dyadic, so its float32 arithmetic
# is exact in any summation order and both sides round the same values
IN_HW, OUT_HW = (32, 48), (64, 96)
THRESHOLD = 0.2  # between the slots' scores at this seed: some kept, some not


@pytest.fixture(scope='module')
def models():
    jax_cfg = jax_configuration.Mask2FormerConfig.tiny_test(num_labels=3)
    jax_model = JaxMask2Former(jax_cfg)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0.0, 0.02, np.shape(x)).astype(np.float32),
        init_params(jax_model, jax_cfg, seed=0, image_hw=OUT_HW),
    )
    model = Mask2Former(Mask2FormerConfig.tiny_test(num_labels=3)).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return jax_model, params, model


def _raw(seed, batch=2):
    return np.random.default_rng(seed).integers(0, 256, (batch, *IN_HW, 3), dtype=np.uint8)


def test_serving_matches_jax(models, monkeypatch):
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    jax_model, params, model = models
    raw = _raw(0)
    want = jax.jit(jax_make_serving_fn(jax_model, params, out_hw=OUT_HW,
                                       threshold=THRESHOLD))(jnp.asarray(raw))
    got = make_serving_fn(model, out_hw=OUT_HW, threshold=THRESHOLD)(torch.from_numpy(raw))
    assert set(got) == set(want)
    valid = got['valid'].numpy()
    assert valid.any() and not valid.all()
    for key in ('valid', 'segment_ids', 'labels', 'segmentation', 'masks'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got['scores'].numpy(), np.asarray(want['scores']), atol=2e-6)
    assert got['segmentation'].shape == (2, *OUT_HW)


def test_micro_batch_and_lean_response(models):
    """micro_batch runs sub-batches one after another: same results as one
    pass; emit_masks=False drops only the masks."""
    _, _, model = models
    raw = torch.from_numpy(_raw(1, batch=4))
    full = make_serving_fn(model, out_hw=OUT_HW, threshold=THRESHOLD)(raw)
    micro = make_serving_fn(model, out_hw=OUT_HW, threshold=THRESHOLD, micro_batch=2,
                            emit_masks=False)(raw)
    assert set(micro) == set(full) - {'masks'}
    for key in micro:
        if key == 'scores':
            torch.testing.assert_close(micro[key], full[key], atol=1e-6, rtol=0)
        else:
            assert torch.equal(micro[key], full[key]), key
    with pytest.raises(ValueError, match='divisible'):
        make_serving_fn(model, out_hw=OUT_HW, micro_batch=3)(raw)


def test_build_model_is_seeded():
    a = build_model('tiny-test', num_labels=3, device='cpu', seed=0)
    b = build_model('tiny-test', num_labels=3, device='cpu', seed=0)
    c = build_model('tiny-test', num_labels=3, device='cpu', seed=1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa['class_predictor.weight'], sc['class_predictor.weight'])
    # the JAX initialisers that matter for sane outputs
    msda = a.pixel_decoder.encoder_layer_0.self_attn
    assert not msda.sampling_offsets.weight.any() and msda.sampling_offsets.bias.any()
    assert not msda.attention_weights.weight.any()
    assert build_model('tiny-test', 3, dtype=torch.bfloat16, device='cpu') \
        .class_predictor.weight.dtype == torch.bfloat16
    assert not a.training


def test_build_model_runs_on_the_card_unless_asked(monkeypatch):
    """The default device is the card: without one it raises rather than
    falling back to the CPU. ``train=True`` gives float32 parameters in train
    mode."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_model('tiny-test', num_labels=3)
    model = build_model('tiny-test', num_labels=3, device='cpu', train=True, remat=True)
    assert model.training and model.backbone.remat and model.pixel_decoder.remat
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match='float32 parameters'):
        build_model('tiny-test', num_labels=3, dtype=torch.bfloat16, device='cpu', train=True)


_BLOCKED_IMPORTS = r'''
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'PIL', 'matplotlib', 'transformers',
             'safetensors', 'yaml', 'weed_instance_segmentation_tpu'):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
import weed_instance_segmentation_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
from weed_instance_segmentation_tpu_torch.engine.export import make_serving_fn
from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import make_train_collate
from weed_instance_segmentation_tpu_torch.datasets.loader import to_device
from weed_instance_segmentation_tpu_torch.engine.steps import make_optimizer, make_train_step
model = build_model('tiny-test', num_labels=3, device='cpu', seed=0)
raw = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8))
res = make_serving_fn(model, out_hw=(64, 64), threshold=0.0)(raw)
assert res['segmentation'].shape == (1, 64, 64), res['segmentation'].shape
model = build_model('tiny-test', num_labels=3, device='cpu', seed=0, train=True, remat=True)
step = make_train_step(model, model.config, make_optimizer(model.parameters(), 5e-5))
sample = {'pixel_values': np.zeros((3, 64, 64), np.float32),
          'mask_labels': np.ones((1, 64, 64), np.uint8), 'class_labels': np.zeros(1, np.int64)}
loss = step(to_device(make_train_collate((64, 64), 2, 1)([sample]), 'cpu'))
assert torch.isfinite(loss), loss
# the evaluation path: a checkpoint, a crop_weed-style Test cache, engine.test
import os, tempfile
from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import process_and_save
from weed_instance_segmentation_tpu_torch.engine.checkpoint import save_pretrained
from weed_instance_segmentation_tpu_torch.engine.test import test_model
root = tempfile.mkdtemp()
model = build_model('tiny-test', num_labels=2, device='cpu', seed=0)
save_pretrained(os.path.join(root, 'models', 'run', 'best_model'), model.state_dict(),
                model.config)
original = np.zeros((80, 96), np.int32)
original[10:40, 20:60] = 1
process_and_save([{'pixel_values': np.zeros((3, 64, 64), np.float32),
                   'mask_labels': np.ones((1, 64, 64), np.uint8),
                   'class_labels': np.zeros(1, np.int64), 'target_size': (80, 96),
                   'original_map': original, 'id_to_semantic': {1: 0},
                   'file_name': f'img_{i}.png'} for i in range(3)],
                 os.path.join(root, 'Processed', 'Test'))
config.MODELS_OUTPUT_DIR = os.path.join(root, 'models') + '/'
config.DATASET_LIST = ['crop_weed']
definitions.PROCESSED_DIR = os.path.join(root, 'Processed') + '/'
result = test_model('latest/best_model', device='cpu')
assert set(result) >= {'map', 'map_50', 'map_75', 'classes'}, result
# the inspection entry points' compute half: inference on an array at the
# processor's output size (no resize runs) and the worst-prediction scoring
# over the cache; reading an image file and drawing need PIL and matplotlib
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import PreprocessedDataset
from weed_instance_segmentation_tpu_torch.engine import inference
from weed_instance_segmentation_tpu_torch.engine.model_utils import load_model, plot_segmentation
from weed_instance_segmentation_tpu_torch.engine.show_worst_predictions import score_images
from weed_instance_segmentation_tpu_torch.engine.steps import make_forward_fn
from weed_instance_segmentation_tpu_torch.processing.image_processor import (
    Mask2FormerImageProcessor,
)
model, cfg = load_model('run/best_model', device='cpu')
processor = Mask2FormerImageProcessor(size={'shortest_edge': 64, 'longest_edge': 96})
image = np.random.default_rng(1).integers(0, 256, (64, 96, 3), dtype=np.uint8)
resized, res = inference.run_inference_array(image, make_forward_fn(model), processor, 'cpu')
assert resized is image and res['segmentation'].shape == (64, 96), res['segmentation'].shape
scored = score_images(make_forward_fn(model),
                      PreprocessedDataset(os.path.join(root, 'Processed', 'Test')), 'cpu')
assert len(scored) == 3 and [c['score'] for c in scored] == sorted(c['score'] for c in scored)
for call in (lambda: inference.run_inference(os.path.join(root, 'image.png'),
                                             make_forward_fn(model), processor, 'cpu'),
             lambda: plot_segmentation(image, res)):
    try:
        call()
    except ImportError:
        pass
    else:
        raise AssertionError('an image was read or drawn without PIL or matplotlib')
# the trainer, one tiny epoch from a pre-written pheno_bench cache, as the
# card trains (no raw image is read)
from weed_instance_segmentation_tpu_torch.datasets.pheno_bench import definitions as pheno_bench
from weed_instance_segmentation_tpu_torch.engine import train
for split, n in (('Train', 3), ('Validate', 1), ('Test', 1)):
    process_and_save([{'pixel_values': np.zeros((3, 64, 64), np.float32),
                       'mask_labels': (original[None, :64, :64] == 1).astype(np.uint8),
                       'class_labels': np.ones(1, np.int64), 'target_size': (80, 96),
                       'original_map': original, 'id_to_semantic': {1: 1},
                       'file_name': f'{split}_{i}.png'} for i in range(n)],
                     os.path.join(root, 'pheno', 'Processed', split))
pheno_bench.PROCESSED_DIR = os.path.join(root, 'pheno', 'Processed') + '/'
for name, value in (('EPOCHS', 1), ('BATCH_SIZE', 2), ('MODEL_ARCH', 'tiny-test'),
                    ('MODEL_CHECKPOINT', os.path.join(root, 'none'))):
    setattr(config, name, value)
metadata = train.train(os.path.join(root, 'run'), {}, ['pheno_bench'], device='cpu')
assert len(metadata['training_history']) == 1 and 'test_metrics' in metadata, metadata
# a raw read needs PIL, and raises ImportError at the call without it
from weed_instance_segmentation_tpu_torch.datasets.base import open_rgb
try:
    open_rgb(os.path.join(root, 'image.png'))
except ImportError:
    pass
else:
    raise AssertionError('open_rgb ran without PIL')
print('imported', len(names), 'modules')
'''


def test_port_imports_nothing_of_jax():
    """Every port module imports, and a tiny serving call, a tiny train
    step, a tiny CPU ``engine.test`` over a fixture cache, a tiny
    ``run_inference_array`` and worst-prediction scoring, and one tiny
    trainer epoch from a pre-written cache run, with jax, flax, PIL,
    matplotlib, transformers, safetensors, yaml and the JAX package made
    unimportable; reading an image file or drawing raises ImportError."""
    env = {**os.environ, 'PYTHONPATH': REPO + os.pathsep + os.environ.get('PYTHONPATH', '')}
    proc = subprocess.run([sys.executable, '-c', _BLOCKED_IMPORTS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'imported' in proc.stdout
