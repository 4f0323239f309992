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
import flax.linen

from weed_instance_segmentation_tpu.engine.model_utils import init_params
from weed_instance_segmentation_tpu.models import configuration as jax_configuration
from weed_instance_segmentation_tpu.models import pixel_decoder as jax_pixel_decoder
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
from weed_instance_segmentation_tpu_torch.models import pixel_decoder
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


def _msda_inputs(rng, b, heads, dim, q, shapes, points=4, reach=0.0):
    total = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, total, heads, dim)).astype(np.float32)
    locs = (rng.random((b, q, heads, len(shapes), points, 2)) * (1 + 2 * reach) - reach
            ).astype(np.float32)
    logits = rng.standard_normal((b, q, heads, len(shapes) * points))
    weights = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    weights = weights.reshape(b, q, heads, len(shapes), points).astype(np.float32)
    return value, locs, weights


def test_msda_gradients_match_jax():
    """float32: the port's backward (``autograd.Function``: the value
    gradient summed by ``index_add_``, the location and weight gradients by
    autograd of the fused form) against ``jax.grad`` through the JAX
    package's custom VJP, with locations past [0, 1]; atol 1e-5."""
    from weed_instance_segmentation_tpu.ops.msda_select import msda as jax_msda

    shapes = ((6, 8), (3, 4), (2, 2))
    value, locs, weights = _msda_inputs(np.random.default_rng(12), 2, 2, 8, 11, shapes,
                                        reach=0.2)
    cot = np.random.default_rng(13).standard_normal((2, 11, 16)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_msda(a[0], shapes, a[1], a[2]) * cot),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (value, locs, weights)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (value, locs, weights)]
    (msda(ins[0], shapes, ins[1], ins[2]) * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(('value', 'locations', 'weights'), ins, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), atol=1e-5, err_msg=name)


def test_msda_second_backward_raises():
    """A second backward through one graph (``retain_graph=True``) raises
    where the location or weight gradient is wanted, as the inner graph is
    gone; the value gradient alone may be taken again."""
    shapes = ((4, 6), (2, 3))
    value, locs, weights = (torch.from_numpy(a) for a in _msda_inputs(
        np.random.default_rng(16), 1, 2, 8, 5, shapes))
    out = msda(value, shapes, locs.requires_grad_(), weights).sum()
    out.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match='a second time'):
        out.backward()
    out = msda(value.requires_grad_(), shapes, locs.detach(), weights).sum()
    out.backward(retain_graph=True)
    first = value.grad.clone()
    out.backward()
    assert torch.equal(value.grad, 2 * first)


@pytest.mark.parametrize('needs', ['all', 'value-only', 'locations-only'])
def test_msda_forward_bits_unchanged_under_autograd(needs):
    """The ``autograd.Function``'s forward is the fused form: at bf16 its
    output equals, bit for bit, the no-grad call and the JAX package's
    ``msda_fused``; and its location and weight gradients equal, bit for
    bit, autograd through the fused form with the values held constant."""
    from weed_instance_segmentation_tpu.ops.msda_fused import msda_fused
    from weed_instance_segmentation_tpu_torch.ops.deformable_attention import _msda_fused

    shapes = ((4, 6), (2, 3), (1, 2))
    value, locs, weights = (torch.from_numpy(a).bfloat16() for a in _msda_inputs(
        np.random.default_rng(14), 2, 2, 8, 9, shapes, reach=0.1))
    grads = {'all': (True, True, True), 'value-only': (True, False, False),
             'locations-only': (False, True, False)}[needs]
    ins = [t.clone().requires_grad_(r) for t, r in zip((value, locs, weights), grads)]
    out = msda(ins[0], shapes, ins[1], ins[2])
    with torch.no_grad():
        plain = msda(value, shapes, locs, weights)
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    want = msda_fused(as_jax(value), shapes, as_jax(locs), as_jax(weights))
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    assert torch.equal(out, plain)
    np.testing.assert_array_equal(_np(out.float()), np.asarray(want.astype(jnp.float32)))

    cot = torch.from_numpy(np.random.default_rng(15).standard_normal(out.shape)).bfloat16()
    out.backward(cot)
    ref = [value.detach()] + [t.clone().requires_grad_(r) for t, r in
                              zip((locs, weights), grads[1:])]
    if any(grads[1:]):
        _msda_fused(ref[0], shapes, ref[1], ref[2]).backward(cot)
    for t, r, needed in zip(ins[1:], ref[1:], grads[1:]):
        assert (t.grad is None) == (not needed)
        if needed:
            assert torch.equal(t.grad, r.grad)
    assert (ins[0].grad is not None) == grads[0]


def test_msda_value_grad_sums_in_float32_at_bf16():
    """The bf16 value gradient at the pixel decoder's level shapes for an
    800² input ((25, 25), (50, 50), (100, 100); 8 heads, D 32, 4 points,
    Q = L = 13125), against the float64 gradient of the same inputs: its
    largest error is at most 1.25x that of the JAX package's
    ``msda_value_grad_einsum``. Both sum in float32. Measured at this seed:
    0.351 % of the largest entry for the port, 0.404 % for the JAX package;
    autograd through the fused form, which adds every tap into a bf16
    table, gave 1.774 % (4.4x)."""
    from weed_instance_segmentation_tpu.ops.msda_transpose import msda_value_grad_einsum
    from weed_instance_segmentation_tpu_torch.ops.deformable_attention import _taps

    shapes = ((25, 25), (50, 50), (100, 100))
    b, heads, dim, points = 1, 8, 32, 4
    total = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(0)
    value, locs, weights = (torch.from_numpy(a).bfloat16() for a in _msda_inputs(
        rng, b, heads, dim, total, shapes, points))
    cot = torch.from_numpy(rng.standard_normal((b, total, heads * dim)).astype(np.float32)
                           ).bfloat16()

    exact = torch.zeros((b * heads * total, dim), dtype=torch.float64)
    for idx, wgt in _taps(shapes, total, b, heads, locs.double(), weights.double(),
                          torch.float64):
        taps = cot.double().reshape(b, total, heads, 1, dim) * wgt[..., None]
        exact.index_add_(0, idx.reshape(-1), taps.reshape(-1, dim))
    exact = exact.reshape(b, heads, total, dim).transpose(1, 2)
    scale = exact.abs().max().item()

    leaf = value.clone().requires_grad_()
    msda(leaf, shapes, locs, weights).backward(cot)
    assert leaf.grad.dtype == torch.bfloat16
    port_err = (leaf.grad.double() - exact).abs().max().item() / scale

    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    jax_grad = msda_value_grad_einsum(shapes, as_jax(locs), as_jax(weights), as_jax(cot),
                                      jnp.bfloat16)
    jax_err = np.abs(np.asarray(jax_grad.astype(jnp.float32), np.float64)
                     - exact.numpy()).max() / scale
    assert port_err <= 1.25 * jax_err, (port_err, jax_err)


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


def test_encode_then_decode_gives_the_forward_bits(tiny):
    """``encode`` and ``decode``, called apart, give ``forward``'s bits."""
    _, _, model = tiny
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 3, *IMAGE_HW))
                         .astype(np.float32))
    with torch.no_grad():
        whole = model(x)
        mask_features, multi_scale = model.encode(x)
        halves = model.decode(mask_features, multi_scale)
    assert mask_features.shape == (2, IMAGE_HW[0] // 4, IMAGE_HW[1] // 4, 32)
    assert len(multi_scale) == 3

    def flat(out):
        return [out.class_queries_logits, out.masks_queries_logits,
                *out.aux_class_queries_logits, *out.aux_masks_queries_logits]

    assert len(flat(whole)) == len(flat(halves)) == 8
    for a, b in zip(flat(whole), flat(halves)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('route', ['bf16-params', 'autocast'])
def test_msda_inputs_match_jax_at_bf16(monkeypatch, route):
    """One encoder layer's deformable attention at bf16 in both stacks, with
    the same weights: the values, sampling locations and attention weights
    each stack hands to its MSDA, and the MSDA's output, agree bit for bit.
    Both form the softmax and the locations in the compute dtype (a location
    on the 64-wide level moves by up to a quarter pixel when rounded), and
    both MSDA cores round each tap weight to bf16 and sum in bf16. The three
    projections are fed the JAX package's outputs: a flax ``Dense`` rounds
    its product before adding the bias, a torch ``Linear`` once after, so
    they differ by a bf16 ulp, which is not what this test is about.
    ``bf16-params`` is the serving route (bf16 weights), ``autocast`` the
    training route (float32 weights under bf16 autocast)."""
    config = Mask2FormerConfig.tiny_test(num_labels=3)
    jax_layer = jax_pixel_decoder.EncoderLayer(
        jax_configuration.Mask2FormerConfig.tiny_test(num_labels=3), dtype=jnp.bfloat16)
    shapes = ((2, 16), (4, 32), (8, 64))
    rng = np.random.default_rng(9)
    seq = sum(h * w for h, w in shapes)
    bf16 = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    hidden = bf16(rng.standard_normal((2, seq, config.feature_size)))
    pos = bf16(rng.standard_normal((1, seq, config.feature_size)))
    ref = jax_pixel_decoder.reference_points_constant(shapes)
    params = _noisy(jax_layer.init(jax.random.PRNGKey(0), hidden, pos, ref, shapes)['params'],
                    seed=10, scale=0.05)

    recorded = {}

    def spy(stack, msda_fn):
        def call(value, spatial_shapes, locations, weights):
            out = msda_fn(value, spatial_shapes, locations, weights)
            recorded[stack] = [np.asarray(t.astype(jnp.float32)) if stack == 'jax'
                               else _np(t.float()) for t in (value, locations, weights, out)]
            recorded[stack + '_dtypes'] = (locations.dtype, weights.dtype)
            return out
        return call

    monkeypatch.setattr(jax_pixel_decoder, 'msda', spy('jax', jax_pixel_decoder.msda))
    monkeypatch.setattr(pixel_decoder, 'msda', spy('port', pixel_decoder.msda))
    as_bf16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    _, state = jax_layer.apply({'params': params}, as_bf16(hidden), as_bf16(pos), ref, shapes,
                               capture_intermediates=True)
    projections = state['intermediates']['self_attn']

    layer = pixel_decoder.EncoderLayer(config).eval()
    layer.load_state_dict(params_from_jax(params), strict=True)
    for name in ('value_proj', 'sampling_offsets', 'attention_weights'):
        jax_out = np.array(projections[name]['__call__'][0].astype(jnp.float32))
        getattr(layer.self_attn, name).register_forward_hook(
            lambda module, args, out, a=jax_out: torch.from_numpy(a).to(out.dtype))
    if route == 'bf16-params':
        layer = layer.to(torch.bfloat16)
        ins = [torch.from_numpy(a).bfloat16() for a in (hidden, pos)]
    else:
        ins = [torch.from_numpy(a) for a in (hidden, pos)]
    with torch.no_grad(), torch.autocast('cpu', dtype=torch.bfloat16,
                                         enabled=route == 'autocast'):
        layer(*ins, torch.from_numpy(ref), shapes)

    assert recorded['jax_dtypes'] == (jnp.bfloat16, jnp.bfloat16)
    assert recorded['port_dtypes'] == (torch.bfloat16, torch.bfloat16)
    for name, got, want in zip(('value', 'locations', 'weights', 'msda output'),
                               recorded['port'], recorded['jax']):
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_msda_input_grads_near_jax_at_bf16(monkeypatch):
    """The bf16 backward of one encoder layer's deformable attention, on the
    training route (float32 weights under bf16 autocast), in both stacks:
    the gradients that reach the value, sampling-offset and attention-weight
    projections' outputs from one cotangent on the MSDA output. Both stacks
    start from the same projection outputs (the JAX package's). The routes
    differ: both split the backward as the JAX package's custom VJP
    (``ops/msda_select.py``) does, locations and weights by differentiating
    the fused form with the values held constant, but the JAX value gradient
    is a dense einsum (``ops/msda_transpose.py``) and the port's a float32
    ``index_add_`` of the rounded taps; and each stack rounds the softmax's
    backward its own way (both stop the gradient at the max). So most
    entries differ in their last bits (50-65 % here); at this seed the
    largest gap is 0.38 % of the largest gradient for the values (1.15 %
    while the port summed the value gradient in bf16), 0.74 % for the
    offsets and 0.78 % for the attention logits. The bound is one bf16 ulp
    of the largest gradient (2**-7 of it) for the values and two (2**-6)
    for the offsets and the attention logits."""
    names = ('value_proj', 'sampling_offsets', 'attention_weights')
    config = Mask2FormerConfig.tiny_test(num_labels=3)
    jax_layer = jax_pixel_decoder.EncoderLayer(
        jax_configuration.Mask2FormerConfig.tiny_test(num_labels=3), dtype=jnp.bfloat16)
    shapes = ((2, 16), (4, 32), (8, 64))
    rng = np.random.default_rng(9)
    seq = sum(h * w for h, w in shapes)
    bf16 = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    hidden = bf16(rng.standard_normal((2, seq, config.feature_size)))
    pos = bf16(rng.standard_normal((1, seq, config.feature_size)))
    cotangent = rng.standard_normal((2, seq, config.feature_size)).astype(np.float32)
    ref = jax_pixel_decoder.reference_points_constant(shapes)
    params = _noisy(jax_layer.init(jax.random.PRNGKey(0), hidden, pos, ref, shapes)['params'],
                    seed=10, scale=0.05)
    _, state = jax_layer.apply({'params': params}, hidden, pos, ref, shapes,
                               capture_intermediates=True)
    projections = {name: state['intermediates']['self_attn'][name]['__call__'][0]
                   for name in names}

    msda_out = {}

    def spy(stack, msda_fn):
        def call(*args):
            msda_out[stack] = msda_fn(*args)
            return msda_out[stack]
        return call

    monkeypatch.setattr(jax_pixel_decoder, 'msda', spy('jax', jax_pixel_decoder.msda))
    monkeypatch.setattr(pixel_decoder, 'msda', spy('port', pixel_decoder.msda))

    def jax_loss(outs):
        def given(next_fun, args, kwargs, context):
            module = context.module
            if (context.method_name == '__call__' and module.name in names
                    and module.parent.name == 'self_attn'):
                return outs[module.name]
            return next_fun(*args, **kwargs)
        with flax.linen.intercept_methods(given):
            jax_layer.apply({'params': params}, hidden, pos, ref, shapes)
        return jnp.sum(msda_out['jax'].astype(jnp.float32) * cotangent)

    want = jax.grad(jax_loss)(projections)

    layer = pixel_decoder.EncoderLayer(config)
    layer.load_state_dict(params_from_jax(params), strict=True)
    leaves = {}
    for name in names:
        leaves[name] = torch.from_numpy(np.array(projections[name].astype(jnp.float32))
                                        ).bfloat16().requires_grad_()
        getattr(layer.self_attn, name).register_forward_hook(
            lambda module, args, out, leaf=leaves[name]: leaf)
    with torch.autocast('cpu', dtype=torch.bfloat16):
        layer(torch.from_numpy(hidden), torch.from_numpy(pos), torch.from_numpy(ref), shapes)
    (msda_out['port'].float() * torch.from_numpy(cotangent)).sum().backward()

    for name in names:
        got = _np(leaves[name].grad.float())
        expected = np.array(want[name].astype(jnp.float32))
        assert leaves[name].grad.dtype == torch.bfloat16 and got.shape == expected.shape, name
        scale = np.abs(expected).max()
        assert scale > 0, name
        bound = 2.0 ** -7 if name == 'value_proj' else 2.0 ** -6
        assert np.abs(got - expected).max() <= scale * bound, name
