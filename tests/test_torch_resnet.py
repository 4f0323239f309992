"""The port's ResNet backbone and Mask2Former-R50 against the JAX package at
tiny shapes on the CPU, and ``config_for_arch`` across the two packages.

Weights are the JAX package's flax params with seeded numpy noise on every
leaf (so the frozen batch norms' unit and zero statistics are exercised
too), carried over with ``params_from_jax`` and loaded with ``strict=True``.
The tiny R50 is ``tests/test_resnet.py``'s: depths (1, 1, 1, 1), width 8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weed_instance_segmentation_tpu.engine import model_utils as jax_model_utils
from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former
from weed_instance_segmentation_tpu.models.resnet import (
    FrozenBatchNorm as JaxFrozenBatchNorm, ResNetBackbone as JaxResNetBackbone,
)

from weed_instance_segmentation_tpu_torch.engine import model_utils
from weed_instance_segmentation_tpu_torch.engine.steps import make_loss_fn, step_draws
from weed_instance_segmentation_tpu_torch.models.configuration import (
    Mask2FormerConfig, ResNetConfig,
)
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax, state_dict_to_jax
from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2Former
from weed_instance_segmentation_tpu_torch.models.resnet import FrozenBatchNorm, ResNetBackbone

IMAGE_HW = (64, 96)  # non-square, so H and W mix-ups show
TINY_R50 = dict(depths=(1, 1, 1, 1), embed_dim=8)


def _noisy(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0.0, scale, np.shape(x)).astype(np.float32),
        params,
    )


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope='module')
def tiny_r50():
    """(jax model, noisy jax params, port model with the same weights)."""
    jax_cfg = jax_configuration.Mask2FormerConfig.tiny_test(
        backbone_config=jax_configuration.ResNetConfig(**TINY_R50), num_labels=3)
    jax_model = JaxMask2Former(jax_cfg)
    params = _noisy(init_params(jax_model, jax_cfg, seed=0, image_hw=IMAGE_HW), seed=1)
    model = Mask2Former(Mask2FormerConfig.tiny_test(
        backbone_config=ResNetConfig(**TINY_R50), num_labels=3)).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return jax_model, params, model


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_frozen_batch_norm_matches_flax(dtype):
    """The fold of the JAX module: the factor rounded to the compute dtype
    before the shift is formed from it in float32. bf16: the same bits;
    float32: within float32 rounding (XLA fuses the multiply-add)."""
    rng = np.random.default_rng(0)
    c = 16
    params = {'scale': rng.normal(1.0, 0.5, c), 'bias': rng.normal(0.0, 0.5, c),
              'mean': rng.normal(0.0, 0.5, c), 'var': rng.uniform(0.2, 2.0, c)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((2, 5, 7, c)).astype(np.float32)
    want = JaxFrozenBatchNorm(c, dtype=jnp.dtype(dtype)).apply(
        {'params': params}, jnp.asarray(x).astype(dtype))
    want = np.asarray(want.astype(jnp.float32))
    bn = FrozenBatchNorm(c)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=True)
    with torch.no_grad():
        got = bn(torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2))
    assert got.dtype == getattr(torch, dtype)
    got = _np(got.permute(0, 2, 3, 1))
    if dtype == 'bfloat16':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_resnet_backbone_matches_jax():
    """The four NHWC stage features (strides 4/8/16/32), float32."""
    jax_backbone = JaxResNetBackbone(jax_configuration.ResNetConfig(**TINY_R50))
    x = np.random.default_rng(2).standard_normal((2, *IMAGE_HW, 3)).astype(np.float32)
    params = _noisy(jax.jit(jax_backbone.init)(jax.random.PRNGKey(0), jnp.asarray(x))['params'],
                    seed=3)
    want = jax.jit(lambda p, v: jax_backbone.apply({'params': p}, v))(params, jnp.asarray(x))

    backbone = ResNetBackbone(ResNetConfig(**TINY_R50)).eval()
    backbone.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = backbone(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 16, 24, 32), (2, 8, 12, 64), (2, 4, 6, 128), (2, 2, 3, 256)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5)


def test_r50_mask2former_forward_matches_jax(tiny_r50):
    """Final and auxiliary class and mask logits, float32, at
    ``tests/test_torch_models.py``'s tolerance for the Swin model."""
    jax_model, params, model = tiny_r50
    x = np.random.default_rng(8).standard_normal((2, 3, *IMAGE_HW)).astype(np.float32)
    want = jax.jit(lambda p, v: jax_model.apply({'params': p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    pairs = [(got.class_queries_logits, want.class_queries_logits),
             (got.masks_queries_logits, want.masks_queries_logits)]
    pairs += list(zip(got.aux_class_queries_logits, want.aux_class_queries_logits))
    pairs += list(zip(got.aux_masks_queries_logits, want.aux_masks_queries_logits))
    assert len(pairs) == 8
    for g, w in pairs:
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-4)


def test_r50_params_round_trip(tiny_r50):
    """Every flax leaf fills one ``state_dict`` entry (the frozen batch
    norms keep ``scale``/``bias``/``mean``/``var``; kernels HWIO → OIHW),
    and ``state_dict_to_jax`` gives the same flax tree back."""
    _, params, model = tiny_r50
    sd = params_from_jax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert set(sd) == set(model.state_dict())
    bn = params['backbone']['stage1_block0']['downsample_bn']
    for name in ('scale', 'bias', 'mean', 'var'):
        np.testing.assert_array_equal(
            sd[f'backbone.stage1_block0.downsample_bn.{name}'].numpy(), bn[name])
    np.testing.assert_array_equal(sd['backbone.stem_conv.weight'].numpy(),
                                  params['backbone']['stem_conv']['kernel'].transpose(3, 2, 0, 1))
    back = state_dict_to_jax(model.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_r50_train_step_gives_finite_gradients():
    """One CPU forward and backward of the training loss on a tiny R50
    initialised by ``init_weights``: a finite loss and a finite gradient for every
    parameter, the frozen batch norms' four included."""
    cfg = Mask2FormerConfig.tiny_test(backbone_config=ResNetConfig(**TINY_R50), num_labels=3)
    model = Mask2Former(cfg)
    model_utils.init_weights(model, seed=0)
    model.train()
    rng = np.random.default_rng(5)
    masks = np.zeros((2, 3, *IMAGE_HW), np.float32)
    masks[0, 0, 8:40, 10:50] = masks[0, 1, 30:60, 50:90] = masks[1, 0, 5:25, 5:95] = 1
    batch = {'pixel_values': torch.from_numpy(
                 rng.standard_normal((2, 3, *IMAGE_HW)).astype(np.float32)),
             'mask_labels': torch.from_numpy(masks),
             'class_labels': torch.tensor([[0, 2, 0], [1, 0, 0]]),
             'instance_valid': torch.tensor([[1, 1, 0], [1, 0, 0]])}
    loss, _ = make_loss_fn(model, cfg)(batch, step_draws(0, 0, 'cpu'))
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert any(p.grad.abs().max() > 0 for name, p in model.named_parameters()
               if name.startswith('backbone.') and name.endswith('.scale'))


def test_config_for_arch_matches_jax():
    """``resnet50`` gives the JAX package's config: R50 (3-4-6-3, width 64,
    channels 256…2048), 100 queries, and the same ``config.json``
    dictionary; neither writes a backbone ``model_type`` for ResNet, so both
    read that dictionary back as a Swin config (the gap ROADMAP records)."""
    cfg = model_utils.config_for_arch('resnet50', num_labels=5)
    jax_cfg = jax_model_utils.config_for_arch('resnet50', num_labels=5)
    assert cfg.backbone_config == ResNetConfig()
    assert cfg.backbone_config.channels == (256, 512, 1024, 2048) == \
        jax_cfg.backbone_config.channels
    assert cfg.num_queries == jax_cfg.num_queries == 100
    assert cfg.to_hf_dict() == jax_cfg.to_hf_dict()
    assert 'model_type' not in cfg.to_hf_dict()['backbone_config']
    back = Mask2FormerConfig.from_hf_dict(cfg.to_hf_dict())
    jax_back = jax_configuration.Mask2FormerConfig.from_hf_dict(jax_cfg.to_hf_dict())
    assert type(back.backbone_config).__name__ == type(jax_back.backbone_config).__name__ \
        == 'SwinConfig'


def test_encoder_points_from_the_environment(monkeypatch):
    """``WISTPU_ENCODER_POINTS=2`` builds the same model in both packages:
    the sampling-offset and attention-weight shapes agree, the flax params
    load strictly, and a tiny forward agrees at the full-forward tolerance."""
    monkeypatch.setenv('WISTPU_ENCODER_POINTS', '2')
    cfg = model_utils.config_for_arch('tiny-test', num_labels=3)
    jax_cfg = jax_model_utils.config_for_arch('tiny-test', num_labels=3)
    assert cfg.encoder_n_points == jax_cfg.encoder_n_points == 2
    jax_model = JaxMask2Former(jax_cfg)
    params = _noisy(init_params(jax_model, jax_cfg, seed=0, image_hw=IMAGE_HW), seed=4)
    model = Mask2Former(cfg).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    layer = params['pixel_decoder']['encoder_layer_0']['self_attn']
    msda = model.pixel_decoder.encoder_layer_0.self_attn
    assert msda.sampling_offsets.weight.shape[::-1] == layer['sampling_offsets']['kernel'].shape
    assert msda.attention_weights.weight.shape[::-1] == layer['attention_weights']['kernel'].shape
    assert msda.n_points == 2
    x = np.random.default_rng(6).standard_normal((1, 3, *IMAGE_HW)).astype(np.float32)
    want = jax.jit(lambda p, v: jax_model.apply({'params': p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in ((got.class_queries_logits, want.class_queries_logits),
                 (got.masks_queries_logits, want.masks_queries_logits)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-4)
