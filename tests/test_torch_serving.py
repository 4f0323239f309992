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
    a = build_model('tiny-test', num_labels=3, seed=0)
    b = build_model('tiny-test', num_labels=3, seed=0)
    c = build_model('tiny-test', num_labels=3, seed=1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa['class_predictor.weight'], sc['class_predictor.weight'])
    # the JAX initialisers that matter for sane outputs
    msda = a.pixel_decoder.encoder_layer_0.self_attn
    assert not msda.sampling_offsets.weight.any() and msda.sampling_offsets.bias.any()
    assert not msda.attention_weights.weight.any()
    assert build_model('tiny-test', 3, dtype=torch.bfloat16).class_predictor.weight.dtype \
        == torch.bfloat16


_BLOCKED_IMPORTS = r'''
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'PIL', 'transformers',
             'weed_instance_segmentation_tpu'):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
import weed_instance_segmentation_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
from weed_instance_segmentation_tpu_torch.engine.export import make_serving_fn
from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model
model = build_model('tiny-test', num_labels=3, seed=0)
raw = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8))
res = make_serving_fn(model, out_hw=(64, 64), threshold=0.0)(raw)
assert res['segmentation'].shape == (1, 64, 64), res['segmentation'].shape
print('imported', len(names), 'modules')
'''


def test_port_imports_nothing_of_jax():
    """Every port module imports, and a tiny serving call runs, with jax,
    flax, PIL, transformers and the JAX package made unimportable."""
    env = {**os.environ, 'PYTHONPATH': REPO + os.pathsep + os.environ.get('PYTHONPATH', '')}
    proc = subprocess.run([sys.executable, '-c', _BLOCKED_IMPORTS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'imported' in proc.stdout
