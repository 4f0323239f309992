"""The port's serving export (``engine/export.py``): ``export_serving`` →
one saved ``torch.export`` program → ``load_serving``, on the CPU at tiny
shapes, against the eager serving function, against the JAX package's
``make_serving_fn`` with the same weights, and in processes that cannot
import the port's model code or jax.

Two artifacts are exported once per module: tiny-test (Swin) with masks,
and a tiny Mask2Former-R50 without them (``emit_masks=False``), both from
uint8 at a 2x upscale (as ``tests/test_torch_serving.py``: the pre-process
weights are dyadic, so its float32 arithmetic is exact in any order).
"""

import json
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

from weed_instance_segmentation_tpu_torch.engine import export
from weed_instance_segmentation_tpu_torch.engine.export import (
    ARTIFACT_NAME, MANIFEST_NAME, export_serving, load_serving, make_serving_fn,
)
from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model
from weed_instance_segmentation_tpu_torch.models.configuration import (
    Mask2FormerConfig, ResNetConfig,
)
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax
from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2Former
from weed_instance_segmentation_tpu_torch.ops.constants import device_constant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_HW, OUT_HW, BATCH = (32, 48), (64, 96), 2
TINY_R50 = dict(depths=(1, 1, 1, 1), embed_dim=8)
# the keys of the JAX package's manifest, with torch_version for jax_version
MANIFEST_KEYS = {'input', 'model_input_hw', 'target_size', 'threshold', 'platforms',
                 'torch_version', 'emit_masks', 'outputs', 'arch', 'compute_dtype'}
# threshold: between the slots' scores at this seed, so some are kept and some not
ARCHS = {'swin': dict(emit_masks=True, threshold=0.2),
         'r50': dict(emit_masks=False, threshold=0.3)}


def _configs(arch):
    """(JAX config, port config) of the tiny model of ``arch``."""
    if arch == 'swin':
        return (jax_configuration.Mask2FormerConfig.tiny_test(num_labels=3),
                Mask2FormerConfig.tiny_test(num_labels=3))
    return (jax_configuration.Mask2FormerConfig.tiny_test(
                backbone_config=jax_configuration.ResNetConfig(**TINY_R50), num_labels=3),
            Mask2FormerConfig.tiny_test(backbone_config=ResNetConfig(**TINY_R50), num_labels=3))


def _raw(seed):
    return np.random.default_rng(seed).integers(0, 256, (BATCH, *IN_HW, 3), dtype=np.uint8)


@pytest.fixture(scope='module', params=list(ARCHS))
def exported(request, tmp_path_factory):
    """Per arch: the JAX model and its noisy params, the port model with the
    same weights, an input, the eager serve's results before and after the
    export (in this process), the artifact's directory and its loaded
    program's results."""
    arch = request.param
    jax_cfg, cfg = _configs(arch)
    jax_model = JaxMask2Former(jax_cfg)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0.0, 0.02, np.shape(x)).astype(np.float32),
        init_params(jax_model, jax_cfg, seed=0, image_hw=OUT_HW),
    )
    model = Mask2Former(cfg).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    raw = _raw(0)
    knobs = ARCHS[arch]
    serve = make_serving_fn(model, out_hw=OUT_HW, **knobs)
    before = serve(torch.from_numpy(raw))
    device_constant.cache_clear()  # the export builds the constants first, as on a fresh server
    out_dir = str(tmp_path_factory.mktemp(f'serving_{arch}'))
    export_serving(model, out_dir, batch=BATCH, in_hw=IN_HW, out_hw=OUT_HW, **knobs,
                   manifest_extra={'arch': arch, 'compute_dtype': 'float32'})
    after = serve(torch.from_numpy(raw))
    loaded, manifest = load_serving(out_dir)
    return dict(arch=arch, jax_model=jax_model, params=params, model=model, raw=raw,
                before=before, after=after, out_dir=out_dir, manifest=manifest,
                program=loaded.program, loaded=loaded(torch.from_numpy(raw)), **knobs)


def test_loaded_program_gives_the_serving_functions_bits(exported):
    """``load_serving(export_serving(...))`` on the same input: every
    output array the same bits as ``make_serving_fn``'s; the parameters'
    ``requires_grad`` and the model's mode restored."""
    got, want = exported['loaded'], exported['before']
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    valid = want['valid'].numpy()
    assert valid.any() and not valid.all()
    model = exported['model']
    assert not model.training and all(p.requires_grad for p in model.parameters())


def test_loaded_program_matches_jax_serving(exported, monkeypatch):
    """The loaded program against the JAX package's ``make_serving_fn`` with
    the same weights, at ``test_serving_matches_jax``'s tolerances: ids,
    labels, valid flags, segmentation and masks exact, scores within 2e-6."""
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    want = jax.jit(jax_make_serving_fn(
        exported['jax_model'], exported['params'], out_hw=OUT_HW,
        threshold=exported['threshold'], emit_masks=exported['emit_masks']))(
        jnp.asarray(exported['raw']))
    got = exported['loaded']
    assert set(got) == set(want)
    for key in set(got) - {'scores'}:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got['scores'].numpy(), np.asarray(want['scores']), atol=2e-6)


def test_exported_graph_calls_the_kernel_ops(exported):
    """The saved graph calls the registered kernel operators: post-process,
    masked-attention and MSDA forward in both; window-attention forward in
    the Swin model only; no backward."""
    graph = exported['program'].graph
    ops = {str(n.target) for n in graph.nodes if str(n.target).startswith('wistpu.')}
    want = {'wistpu.fused_upsample_stats.default', 'wistpu.masked_attention_fwd.default',
            'wistpu.msda_fwd.default'}
    if exported['arch'] == 'swin':
        want.add('wistpu.window_attention_fwd.default')
    assert ops == want


def test_exported_graph_holds_no_profiler_op(exported):
    """The program's spans leave nothing in the saved graph: no profiler
    range was open while it was traced."""
    targets = [str(n.target) for n in exported['program'].graph.nodes]
    assert targets and not [t for t in targets if 'profiler' in t or 'record_function' in t]


def test_eager_serve_after_an_export_keeps_its_bits(exported):
    """An export traces the pipeline with fake tensors; the device-constant
    cache, emptied before it, must not keep them: the eager serving
    function gives the same bits after the export as before it, in the same
    process."""
    before, after = exported['before'], exported['after']
    assert all(torch.equal(before[key], after[key]) for key in before)


def test_lean_artifact_drops_the_masks(exported):
    """``emit_masks`` in the manifest and the outputs: the masks are there
    only when asked for."""
    assert exported['manifest']['emit_masks'] == exported['emit_masks']
    assert ('masks' in exported['loaded']) == exported['emit_masks']
    if not exported['emit_masks']:
        assert exported['manifest']['outputs'].endswith('masks omitted (id map only)')


def test_manifest_names_the_artifact(exported):
    """The JAX manifest's keys, the CPU as the one platform, and the
    program's input spec."""
    manifest = exported['manifest']
    assert set(manifest) == MANIFEST_KEYS
    assert manifest['platforms'] == ['cpu'] and manifest['torch_version'] == torch.__version__
    assert manifest['input'] == {'shape': [BATCH, *IN_HW, 3], 'dtype': 'uint8',
                                 'layout': 'BHWC raw images'}
    assert manifest['model_input_hw'] == manifest['target_size'] == list(OUT_HW)
    with open(os.path.join(exported['out_dir'], MANIFEST_NAME)) as f:
        assert json.load(f) == manifest


def test_load_serving_refuses_a_missing_device(tmp_path, monkeypatch):
    """An artifact exported on the card does not load without one."""
    with open(tmp_path / MANIFEST_NAME, 'w') as f:
        json.dump({'platforms': ['cuda']}, f)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        load_serving(str(tmp_path))


_LOAD_ALONE = r'''
import sys
for name in ('jax', 'jaxlib', 'flax', 'weed_instance_segmentation_tpu',
             'weed_instance_segmentation_tpu_torch.models'):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
from weed_instance_segmentation_tpu_torch.engine.export import load_serving
serve, manifest = load_serving(sys.argv[1])
torch.save(serve(torch.from_numpy(np.load(sys.argv[2]))), sys.argv[3])
print('served on', manifest['platforms'])
'''


def test_export_cli_then_load_without_model_code(tmp_path):
    """``python -m weed_instance_segmentation_tpu_torch.engine.export`` with
    ``WISTPU_DEVICE=cpu`` and tiny-test at the default compute dtype
    (bfloat16) writes an artifact and a manifest with the JAX CLI's keys and
    the CPU as its platform; then a process that cannot import the port's
    ``models`` package, jax or the JAX package loads it and serves the bits
    of the eager serving function of the same seeded model."""
    out_dir = tmp_path / 'serving'
    env = {**os.environ, 'PYTHONPATH': REPO + os.pathsep + os.environ.get('PYTHONPATH', ''),
           'WISTPU_DEVICE': 'cpu', 'WISTPU_MODEL_ARCH': 'tiny-test',
           'WISTPU_EXPORT_DIR': str(out_dir), 'WISTPU_EXPORT_BATCH': '1',
           'WISTPU_EXPORT_HW_IN': '32', 'WISTPU_EXPORT_HW': '64', 'WISTPU_NUM_LABELS': '3'}
    for name in ('WISTPU_EXPORT_CHECKPOINT', 'WISTPU_COMPUTE_DTYPE', 'WISTPU_EXPORT_MASKS',
                 'WISTPU_EXPORT_THRESHOLD', 'WISTPU_ENCODER_POINTS'):
        env.pop(name, None)
    proc = subprocess.run([sys.executable, '-m', export.__name__], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'exported' in proc.stdout and os.path.exists(out_dir / ARTIFACT_NAME)
    with open(out_dir / MANIFEST_NAME) as f:
        manifest = json.load(f)
    assert set(manifest) == MANIFEST_KEYS
    assert manifest['platforms'] == ['cpu']
    assert manifest['arch'] == 'tiny-test' and manifest['compute_dtype'] == 'bfloat16'
    assert manifest['input']['shape'] == [1, 32, 32, 3] and manifest['emit_masks'] is True
    assert manifest['threshold'] == 0.5 and manifest['model_input_hw'] == [64, 64]

    raw = np.random.default_rng(3).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    np.save(tmp_path / 'raw.npy', raw)
    proc = subprocess.run(
        [sys.executable, '-c', _LOAD_ALONE, str(out_dir), str(tmp_path / 'raw.npy'),
         str(tmp_path / 'got.pt')], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served on ['cpu']" in proc.stdout
    got = torch.load(tmp_path / 'got.pt')
    model = build_model('tiny-test', 3, dtype=torch.bfloat16, device='cpu', seed=0)
    want = make_serving_fn(model, out_hw=(64, 64))(torch.from_numpy(raw))
    assert set(got) == set(want)
    assert all(torch.equal(got[key], want[key]) for key in want)
