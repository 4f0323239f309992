"""PyTorch port vs the JAX package: pre-process, post-process statistics and
instance post-process, on the CPU (where the post-process kernel's wrapper
runs its plain version)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weed_instance_segmentation_tpu.ops.postprocess_kernel import (
    fused_upsample_stats as jax_fused_upsample_stats,
)
from weed_instance_segmentation_tpu.processing.fused import (
    fused_preprocess as jax_fused_preprocess,
)
from weed_instance_segmentation_tpu.processing.postprocess import (
    post_process_instance_arrays as jax_post_process,
)

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.ops.postprocess_kernel import (
    LAUNCHES as POSTPROCESS_LAUNCHES, fused_upsample_stats, fused_upsample_stats_plain,
)
from weed_instance_segmentation_tpu_torch.processing.fused import fused_preprocess
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    post_process_instance_arrays,
)


def _rounding_ties(images, out_hw, tol=1e-3):
    """Output elements whose exact pre-rounding value lies within ``tol`` of
    a half level: there the two float32 computations may round to adjacent
    levels (1/255 before normalisation), depending on summation order."""
    from weed_instance_segmentation_tpu_torch.processing.fused import pil_bilinear_weights

    rh = pil_bilinear_weights(images.shape[1], out_hw[0]).astype(np.float64)
    rw = pil_bilinear_weights(images.shape[2], out_hw[1]).astype(np.float64)
    exact = np.einsum('oh,bhwc,pw->bcop', rh, images.astype(np.float64), rw)
    return np.abs(exact - np.floor(exact) - 0.5) < tol


@pytest.mark.parametrize('in_hw,out_hw,pad_hw', [
    ((48, 40), (32, 24), (40, 32)),  # downscale, padded
    ((48, 40), (96, 80), (96, 80)),  # 2x upscale
    ((128, 128), (100, 100), (100, 100)),  # the serving ratio 1024 → 800
], ids=['down-padded', 'up', 'serving-ratio'])
def test_fused_preprocess_matches_jax(in_hw, out_hw, pad_hw):
    images = np.random.default_rng(0).integers(0, 256, (2, *in_hw, 3), dtype=np.uint8)
    want_px, want_mask = jax_fused_preprocess(jnp.asarray(images), out_hw, pad_hw)
    got_px, got_mask = fused_preprocess(torch.from_numpy(images), out_hw, pad_hw)
    assert got_px.shape == want_px.shape and got_px.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    got = got_px.numpy()[:, :, :out_hw[0], :out_hw[1]]
    want = np.asarray(want_px)[:, :, :out_hw[0], :out_hw[1]]
    ties = _rounding_ties(images, out_hw)
    np.testing.assert_allclose(got[~ties], want[~ties], atol=1e-4)
    # at a tie: equal, or one level apart (1/255 over the smallest ImageNet std)
    assert np.abs(got - want)[ties].max(initial=0.0) <= 1.0 / (255 * 0.224) + 1e-4
    np.testing.assert_array_equal(got_px.numpy()[:, :, out_hw[0]:], 0.0)
    np.testing.assert_array_equal(got_px.numpy()[:, :, :, out_hw[1]:], 0.0)


def test_fused_preprocess_rejects_float_images():
    with pytest.raises(ValueError, match='uint8'):
        fused_preprocess(torch.zeros((1, 8, 8, 3)), (4, 4), (4, 4))


def test_upsample_stats_plain_matches_pallas_kernel():
    """The plain version against the TPU kernel run by the Pallas
    interpreter, at a small scoring size."""
    # small maps: the sums stay below 2**4, where atol 1e-5 is ten float32 ulps
    logits = np.random.default_rng(1).standard_normal((2, 8, 3, 3)).astype(np.float32) * 2
    score_hw = (5, 4)
    want = jax_fused_upsample_stats(jnp.asarray(logits), score_hw, q_tile=4, interpret=True)
    got = fused_upsample_stats_plain(torch.from_numpy(logits), score_hw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)
    assert got[2].dtype == torch.int8
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _random_outputs(seed, b=2, q=12, c=3, h=20, w=20):
    rng = np.random.default_rng(seed)
    class_logits = rng.standard_normal((b, q, c + 1)).astype(np.float32) * 2
    mask_logits = rng.standard_normal((b, q, h, w)).astype(np.float32) * 2
    return class_logits, mask_logits


def _with_ties(class_logits):
    """Equal scores across queries (3 == 5) and across classes (0 == 1), so
    the top-k order of tied entries decides labels and query order."""
    class_logits = class_logits.copy()
    class_logits[:, 5] = class_logits[:, 3]
    class_logits[:, :, 1] = class_logits[:, :, 0]
    return class_logits


@pytest.mark.parametrize('ties', [False, True], ids=['distinct', 'ties'])
@pytest.mark.parametrize('target_size', [(37, 53), (384, 384), (500, 700)])
def test_post_process_matches_jax(monkeypatch, target_size, ties):
    monkeypatch.setenv('WISTPU_POSTPROC_RESIZE', 'matmul')
    class_logits, mask_logits = _random_outputs(2)
    if ties:
        class_logits = _with_ties(class_logits)
    want = jax_post_process(jnp.asarray(class_logits), jnp.asarray(mask_logits),
                            target_size, 0.3)
    launches = trace.counter(POSTPROCESS_LAUNCHES)
    got = post_process_instance_arrays(torch.from_numpy(class_logits),
                                       torch.from_numpy(mask_logits), target_size, 0.3)
    assert trace.counter(POSTPROCESS_LAUNCHES) == launches  # CPU tensors: no kernel launch
    assert got.valid.any()
    for key in ('valid', 'segment_ids', 'labels', 'segmentation', 'masks'):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)), err_msg=key)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=2e-6)
    assert got.segmentation.dtype == torch.int32 and got.segmentation.shape[1:] == target_size


def test_post_process_without_masks():
    class_logits, mask_logits = _random_outputs(3)
    args = (torch.from_numpy(class_logits), torch.from_numpy(mask_logits), (64, 48), 0.3)
    full = post_process_instance_arrays(*args)
    lean = post_process_instance_arrays(*args, with_masks=False)
    assert lean.masks is None
    for key in ('valid', 'segment_ids', 'labels', 'segmentation', 'scores'):
        assert torch.equal(getattr(full, key), getattr(lean, key)), key
