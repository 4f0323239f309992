"""PyTorch port vs the JAX package: model modules at tiny shapes, float32.

Weights are the JAX package's flax params with seeded numpy noise added to
every leaf (so zero-initialised leaves such as ``sampling_offsets``,
``attention_weights``, ``relative_position_bias_table`` and ``level_embed``
are exercised too), carried over with ``params_from_jax`` and loaded with
``strict=True``. Inputs are seeded numpy arrays given to both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models.mask2former import Mask2Former as JaxMask2Former
from weed_instance_segmentation_tpu.models.pixel_decoder import PixelDecoder as JaxPixelDecoder
from weed_instance_segmentation_tpu.models.swin import SwinBackbone as JaxSwinBackbone
from weed_instance_segmentation_tpu.models.transformer_decoder import (
    TransformerModule as JaxTransformerModule,
)
from weed_instance_segmentation_tpu.ops.deformable_attention import msda_reference
from weed_instance_segmentation_tpu.ops.resize import (
    interpolate_bilinear as jax_interpolate_bilinear,
    interpolate_nearest as jax_interpolate_nearest,
)

from weed_instance_segmentation_tpu_torch.models.configuration import (
    Mask2FormerConfig, SwinConfig,
)
from weed_instance_segmentation_tpu_torch.models.convert import params_from_jax
from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2Former
from weed_instance_segmentation_tpu_torch.models.swin import SwinBackbone
from weed_instance_segmentation_tpu_torch.ops.deformable_attention import msda
from weed_instance_segmentation_tpu_torch.ops.resize import (
    interpolate_bilinear, interpolate_nearest,
)

IMAGE_HW = (64, 96)  # non-square, so H and W mix-ups show


def _noisy(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0.0, scale, np.shape(x)).astype(np.float32),
        params,
    )


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope='module')
def tiny():
    """(jax model, noisy jax params, port model with the same weights)."""
    jax_cfg = jax_configuration.Mask2FormerConfig.tiny_test(num_labels=3)
    jax_model = JaxMask2Former(jax_cfg)
    params = _noisy(init_params(jax_model, jax_cfg, seed=0, image_hw=IMAGE_HW), seed=1)
    model = Mask2Former(Mask2FormerConfig.tiny_test(num_labels=3)).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return jax_model, params, model


def test_params_from_jax_consumes_every_leaf(tiny):
    _, params, model = tiny
    sd = params_from_jax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert set(sd) == set(model.state_dict())
    # layout rules: Dense (in, out) → (out, in); Conv HWIO → OIHW; scale → weight
    np.testing.assert_array_equal(
        sd['backbone.stage0_block0.attention.query.weight'].numpy(),
        params['backbone']['stage0_block0']['attention']['query']['kernel'].T)
    np.testing.assert_array_equal(
        sd['backbone.patch_embed.weight'].numpy(),
        params['backbone']['patch_embed']['kernel'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd['pixel_decoder.input_proj_0_norm.weight'].numpy(),
        params['pixel_decoder']['input_proj_0_norm']['scale'])
    with pytest.raises(ValueError, match='rank 3'):
        params_from_jax({'odd': {'kernel': np.zeros((2, 2, 2), np.float32)}})


@pytest.mark.parametrize('depths', [(1, 1, 1, 1), (2, 2, 2, 2)], ids=['tiny', 'shifted'])
def test_swin_matches_jax(depths):
    """(2, 2, 2, 2) runs a shifted-window block in every stage."""
    kw = dict(embed_dim=16, depths=depths, num_heads=(1, 2, 2, 2), window_size=4,
              drop_path_rate=0.0)
    jax_swin = JaxSwinBackbone(jax_configuration.SwinConfig(**kw))
    x = np.random.default_rng(2).standard_normal((2, *IMAGE_HW, 3)).astype(np.float32)
    params = _noisy(jax.jit(jax_swin.init)(jax.random.PRNGKey(0), jnp.asarray(x))['params'], seed=3)
    want = jax.jit(lambda p, v: jax_swin.apply({'params': p}, v))(params, jnp.asarray(x))

    swin = SwinBackbone(SwinConfig(**kw)).eval()
    swin.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = swin(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=2e-4)


def test_msda_matches_reference():
    rng = np.random.default_rng(4)
    b, heads, dim, q = 2, 2, 8, 11
    shapes = ((6, 8), (3, 4), (2, 2))
    total = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, total, heads, dim)).astype(np.float32)
    # locations reach past [0, 1], so zero padding is exercised
    locs = rng.random((b, q, heads, 3, 4, 2)).astype(np.float32) * 1.4 - 0.2
    weights = rng.random((b, q, heads, 3, 4)).astype(np.float32)
    weights /= weights.sum(axis=(-1, -2), keepdims=True)
    want = msda_reference(jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(weights))
    got = msda(torch.from_numpy(value), shapes, torch.from_numpy(locs),
               torch.from_numpy(weights))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_resize_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 3, 7, 10)).astype(np.float32)
    for hw in ((14, 20), (5, 4), (7, 10)):
        np.testing.assert_allclose(
            _np(interpolate_bilinear(torch.from_numpy(x), hw)),
            np.asarray(jax_interpolate_bilinear(jnp.asarray(x), hw)), atol=1e-6)
        np.testing.assert_array_equal(
            _np(interpolate_nearest(torch.from_numpy(x), hw)),
            np.asarray(jax_interpolate_nearest(jnp.asarray(x), hw)))


def _backbone_features(seed):
    """Random NHWC stage features for the tiny config at IMAGE_HW."""
    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4
    feats = []
    for stage, ch in enumerate((16, 32, 64, 128)):
        feats.append(rng.standard_normal((2, h, w, ch)).astype(np.float32))
        h, w = (h + 1) // 2, (w + 1) // 2
    return feats


def test_pixel_decoder_matches_jax(tiny):
    jax_model, params, model = tiny
    feats = _backbone_features(6)
    decoder = JaxPixelDecoder(jax_model.config)
    want_mask, want_ms = jax.jit(lambda p, f: decoder.apply({'params': p}, f))(
        params['pixel_decoder'], [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got_mask, got_ms = model.pixel_decoder([torch.from_numpy(f) for f in feats])
    np.testing.assert_allclose(_np(got_mask), np.asarray(want_mask), atol=5e-4)
    assert len(got_ms) == len(want_ms) == 3
    for g, w in zip(got_ms, want_ms):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-4)


def test_transformer_module_matches_jax(tiny):
    jax_model, params, model = tiny
    rng = np.random.default_rng(7)
    multi_scale = [rng.standard_normal((2, h, w, 32)).astype(np.float32)
                   for h, w in ((2, 3), (4, 6), (8, 12))]
    mask_features = rng.standard_normal((2, 16, 24, 32)).astype(np.float32)
    module = JaxTransformerModule(jax_model.config)
    want_inter, want_masks = jax.jit(lambda p, ms, mf: module.apply({'params': p}, ms, mf))(
        params['transformer_module'], [jnp.asarray(m) for m in multi_scale],
        jnp.asarray(mask_features))
    with torch.no_grad():
        got_inter, got_masks = model.transformer_module(
            [torch.from_numpy(m) for m in multi_scale], torch.from_numpy(mask_features))
    assert len(got_inter) == len(want_inter) == 4
    for g, w in zip(got_inter + got_masks, want_inter + want_masks):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-4)


def test_full_forward_matches_jax(tiny):
    jax_model, params, model = tiny
    x = np.random.default_rng(8).standard_normal((2, 3, *IMAGE_HW)).astype(np.float32)
    want = jax.jit(lambda p, v: jax_model.apply({'params': p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    pairs = [(got.class_queries_logits, want.class_queries_logits),
             (got.masks_queries_logits, want.masks_queries_logits)]
    pairs += list(zip(got.aux_class_queries_logits, want.aux_class_queries_logits))
    pairs += list(zip(got.aux_masks_queries_logits, want.aux_masks_queries_logits))
    assert len(pairs) == 8  # 4 layers × (class, mask)
    for g, w in pairs:
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=5e-4)
