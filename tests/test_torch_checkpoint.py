"""The port's checkpoint I/O against the JAX package's, on the CPU: the
``config.json`` + ``params.npz`` directory either package writes loads in the
other (the parameter tree bit for bit, the same forward), HF checkpoint
directories (``pytorch_model.bin`` and ``model.safetensors``) load as the JAX
package loads them, and ``latest`` in a model id resolves to the newest run."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weed_instance_segmentation_tpu.engine import checkpoint as jax_ckpt
from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.convert import (
    load_hf_checkpoint as jax_load_hf_checkpoint,
)
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former

from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.engine.model_utils import (
    load_model, model_from_state_dict, resolve_model_path,
)
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax, read_safetensors

IMAGE_HW = (64, 96)


@pytest.fixture(scope='module')
def jax_tiny():
    """A tiny-test JAX model with seeded-noise params (every leaf nonzero)."""
    cfg = jax_configuration.Mask2FormerConfig.tiny_test(
        num_labels=3, id2label={0: 'crop', 1: 'weed', 2: 'grass'})
    model = JaxMask2Former(cfg)
    rng = np.random.default_rng(21)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + rng.normal(0.0, 0.02, np.shape(x)).astype(np.float32),
        init_params(model, cfg, seed=0, image_hw=IMAGE_HW))
    return cfg, model, params


def _pixels(seed=22):
    return np.random.default_rng(seed).standard_normal((1, 3, *IMAGE_HW)).astype(np.float32)


def _port_logits(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return out.class_queries_logits.numpy(), out.masks_queries_logits.numpy()


def _tree_items(tree, prefix=''):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _tree_items(value, f'{prefix}{key}/')
        else:
            yield prefix + key, np.asarray(value)


def test_config_json_round_trips_across_packages(tmp_path):
    """Each package's ``config.json`` reads back in the other to the same
    fields, and the two files hold the same JSON."""
    port_cfg = Mask2FormerConfig.swin('large', num_labels=5,
                                      id2label={i: f'c{i}' for i in range(5)})
    port_cfg.save_json(str(tmp_path / 'port'))
    jax_cfg = jax_configuration.Mask2FormerConfig.from_json(str(tmp_path / 'port'))
    jax_cfg.save_json(str(tmp_path / 'jax'))
    back = Mask2FormerConfig.from_json(str(tmp_path / 'jax' / 'config.json'))
    assert back == port_cfg
    assert dataclasses.asdict(jax_cfg) == dataclasses.asdict(port_cfg)
    with open(tmp_path / 'port' / 'config.json') as a, open(tmp_path / 'jax' / 'config.json') as b:
        assert json.load(a) == json.load(b)


def test_jax_checkpoint_loads_in_the_port(jax_tiny, tmp_path):
    """JAX ``save_pretrained`` → the port's ``load_pretrained``: the same
    state_dict as ``params_from_jax`` of the params, bit for bit, and so the
    same forward, bit for bit."""
    cfg, _, params = jax_tiny
    jax_ckpt.save_pretrained(str(tmp_path), params, cfg)
    port_cfg, state_dict = ckpt.load_pretrained(str(tmp_path))
    assert port_cfg.id2label == {0: 'crop', 1: 'weed', 2: 'grass'} and port_cfg.num_labels == 3
    want = params_from_jax(params)
    assert state_dict.keys() == want.keys()
    for key, value in want.items():
        assert state_dict[key].dtype == torch.float32 and torch.equal(state_dict[key], value), key
    x = _pixels()
    got = _port_logits(model_from_state_dict(port_cfg, state_dict, device='cpu'), x)
    expected = _port_logits(model_from_state_dict(port_cfg, want, device='cpu'), x)
    for a, b in zip(got, expected):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_loads_in_jax(jax_tiny, tmp_path):
    """The port's ``save_pretrained`` → JAX ``load_pretrained``: the JAX
    package's own tree, keys, shapes, dtypes and bits, so the JAX model runs
    on it as on the params it started from."""
    cfg, model, params = jax_tiny
    port_cfg = Mask2FormerConfig.from_hf_dict(cfg.to_hf_dict())
    ckpt.save_pretrained(str(tmp_path), params_from_jax(params), port_cfg)
    cfg2, params2 = jax_ckpt.load_pretrained(str(tmp_path))
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(cfg)
    want, got = dict(_tree_items(params)), dict(_tree_items(params2))
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    x = jnp.asarray(_pixels())
    forward = jax.jit(lambda p: model.apply({'params': p}, x, deterministic=True))
    a, b = forward(params), forward(params2)
    np.testing.assert_array_equal(np.asarray(a.masks_queries_logits),
                                  np.asarray(b.masks_queries_logits))


def test_load_model_casts_to_the_compute_dtype(jax_tiny, tmp_path, monkeypatch):
    """``load_model`` loads the float32 parameters, then casts the model to
    ``config.COMPUTE_DTYPE``; without a card the default device raises."""
    cfg, _, params = jax_tiny
    monkeypatch.setattr(config, 'MODELS_OUTPUT_DIR', str(tmp_path) + '/')
    jax_ckpt.save_pretrained(str(tmp_path / 'run' / 'best_model'), params, cfg)
    monkeypatch.setattr(config, 'COMPUTE_DTYPE', 'bfloat16')
    model, port_cfg = load_model('run/best_model', device='cpu')
    assert not model.training and port_cfg.num_labels == 3
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    want = params_from_jax(params)
    for name, p in model.state_dict().items():
        assert torch.equal(p, want[name].bfloat16()), name
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        load_model('run/best_model')


def test_resolve_model_path_latest(tmp_path, monkeypatch):
    """``latest`` resolves to the name-wise newest run directory, explicit
    ids pass through, and a literal ``latest`` directory is kept: the JAX
    package's rule, for the same paths."""
    from weed_instance_segmentation_tpu import config as jax_config
    from weed_instance_segmentation_tpu.engine.model_utils import (
        resolve_model_path as jax_resolve_model_path,
    )

    root = str(tmp_path) + '/'
    monkeypatch.setattr(config, 'MODELS_OUTPUT_DIR', root)
    monkeypatch.setattr(jax_config, 'MODELS_OUTPUT_DIR', root)
    base = tmp_path / 'mask2former_fine_tuned'
    for run in ('2026-01-02_00-00-00', '2026-01-10_12-30-00'):
        (base / run / 'best_model').mkdir(parents=True)
    ids = ['mask2former_fine_tuned/latest/best_model/',
           'mask2former_fine_tuned/2026-01-02_00-00-00/best_model',
           'nothing_here/latest/best_model/']
    got = resolve_model_path(ids[0])
    assert got.rstrip('/') == str(base / '2026-01-10_12-30-00' / 'best_model')
    for model_id in ids:
        assert resolve_model_path(model_id) == jax_resolve_model_path(model_id), model_id
    (base / 'latest' / 'best_model').mkdir(parents=True)
    assert resolve_model_path(ids[0]).rstrip('/') == str(base / 'latest' / 'best_model')


@pytest.fixture(scope='module')
def hf_checkpoints(tmp_path_factory):
    """A random tiny HF Mask2Former saved twice by ``transformers``: as
    ``model.safetensors`` and as ``pytorch_model.bin``."""
    transformers = pytest.importorskip('transformers')
    from transformers.models.mask2former import modeling_mask2former as hf_m2f
    from transformers.models.swin.configuration_swin import SwinConfig as HFSwinConfig

    del transformers
    torch.manual_seed(3)
    swin = HFSwinConfig(
        image_size=224, patch_size=4, num_channels=3, embed_dim=16,
        depths=[1, 1, 1, 1], num_heads=[1, 2, 2, 2], window_size=4,
        drop_path_rate=0.0, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        out_features=['stage1', 'stage2', 'stage3', 'stage4'], use_absolute_embeddings=False)
    cfg = hf_m2f.Mask2FormerConfig(
        backbone_config=swin, feature_size=32, mask_feature_size=32, hidden_dim=32,
        encoder_feedforward_dim=32, dim_feedforward=64, encoder_layers=2,
        decoder_layers=4, num_attention_heads=2, num_queries=10, num_labels=3, dropout=0.0,
        id2label={0: 'crop', 1: 'weed', 2: 'grass'},
        label2id={'crop': 0, 'weed': 1, 'grass': 2})
    model = hf_m2f.Mask2FormerForUniversalSegmentation(cfg).eval()
    dirs = {}
    for name, safe in (('safetensors', True), ('bin', False)):
        d = tmp_path_factory.mktemp(f'hf_{name}')
        model.save_pretrained(str(d), safe_serialization=safe)
        dirs[name] = str(d)
    return dirs


@pytest.mark.parametrize('fmt', ['safetensors', 'bin'])
def test_hf_checkpoint_loads_as_jax_loads_it(hf_checkpoints, fmt):
    """An HF directory through the port's ``load_pretrained`` gives
    ``params_from_jax`` of the JAX package's ``load_hf_checkpoint`` bit for
    bit, and the port's forward on it is the JAX forward within 5e-4 (the
    float32 tolerance of the port's model tests)."""
    import os

    path = hf_checkpoints[fmt]
    assert os.path.exists(os.path.join(
        path, 'model.safetensors' if fmt == 'safetensors' else 'pytorch_model.bin'))
    port_cfg, state_dict = ckpt.load_pretrained(path)
    jax_cfg, params = jax_load_hf_checkpoint(path)
    assert port_cfg.id2label == jax_cfg.id2label == {0: 'crop', 1: 'weed', 2: 'grass'}
    want = params_from_jax(params)
    assert state_dict.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(state_dict[key], value), key

    x = _pixels(23)
    got = _port_logits(model_from_state_dict(port_cfg, state_dict, device='cpu'), x)
    out = jax.jit(lambda p: JaxMask2Former(jax_cfg).apply({'params': p}, jnp.asarray(x),
                                                         deterministic=True))(params)
    for a, b in zip(got, (out.class_queries_logits, out.masks_queries_logits)):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-4)


def test_read_safetensors_matches_the_library(tmp_path):
    """The port's reader against the ``safetensors`` package's own on every
    dtype a checkpoint may hold, an empty tensor and a scalar."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(4)
    tensors = {
        'f32': torch.randn((3, 5), generator=g),
        'bf16': torch.randn((7,), generator=g).bfloat16(),
        'f16': torch.randn((2, 2, 2), generator=g).half(),
        'f64': torch.randn((4,), generator=g).double(),
        'i64': torch.arange(-6, 6).reshape(3, 4),
        'i32': torch.arange(5, dtype=torch.int32),
        'u8': torch.arange(9, dtype=torch.uint8),
        'bool': torch.tensor([True, False, True]),
        'empty': torch.zeros((0, 3)),
        'scalar': torch.tensor(2.5),
    }
    path = str(tmp_path / 'model.safetensors')
    save_file(tensors, path, metadata={'format': 'pt'})
    got, want = read_safetensors(path), load_file(path)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert torch.equal(got[key], value), key
