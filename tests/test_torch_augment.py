"""The port's device-side augmentation (``processing/augment.py``) against the
JAX package's on the CPU: ``apply_factors`` on the factors the JAX
``augment_batch`` draws gives its output (f32, pixels within 1e-5; masks,
pixel mask and ``instance_valid`` exact), and the invariants of
``tests/test_augment.py``: disabled is a passthrough, flips and scales carry
the masks with the pixels, zoom-out clears ``instance_valid``, brightness is
a raw-space multiply, ``from_env``; a data rank draws its rows of the global
factors; and a tiny-test train step with the augmentation on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weed_instance_segmentation_tpu.processing import augment as jax_augment

from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model
from weed_instance_segmentation_tpu_torch.engine.steps import make_optimizer, make_train_step
from weed_instance_segmentation_tpu_torch.processing.augment import (
    AugmentConfig, apply_factors, augment_batch, draw_factors, from_env,
)
from weed_instance_segmentation_tpu_torch.processing.image_processor import (
    IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD,
)

MEAN = np.asarray(IMAGENET_DEFAULT_MEAN, np.float32).reshape(3, 1, 1)
STD = np.asarray(IMAGENET_DEFAULT_STD, np.float32).reshape(3, 1, 1)
CONFIGS = {
    'default': AugmentConfig(),
    'zoom-out': AugmentConfig(hflip_prob=0.5, scale_prob=1.0, scale_range=(0.5, 0.8)),
    'zoom-in': AugmentConfig(hflip_prob=0.0, scale_prob=1.0, scale_range=(1.5, 3.0),
                             brightness=0.4, contrast=0.0),
    'colour': AugmentConfig(hflip_prob=0.0, scale_prob=0.0, brightness=0.3, contrast=0.5),
}


def _batch(b=4, h=32, w=48, n=3, seed=0, padded=True) -> dict:
    """Numpy batch: raw pixels in [0.1, 0.9] normalised, 8 x 8 instance
    squares, and (``padded``) the last rows and columns of each image
    padding, zero in the pixels as the collator leaves them."""
    r = np.random.default_rng(seed)
    raw = r.uniform(0.1, 0.9, size=(b, 3, h, w)).astype(np.float32)
    masks = np.zeros((b, n, h, w), np.float32)
    pixel_mask = np.ones((b, h, w), np.float32)
    for k in range(b):
        for j in range(n):
            y, x = r.integers(2, h - 12), r.integers(2, w - 12)
            masks[k, j, y:y + 8, x:x + 8] = 1.0
        if padded:
            pixel_mask[k, h - 2 - k:, :] = 0.0
            pixel_mask[k, :, w - 3 - k:] = 0.0
    pixels = (raw - MEAN) / STD * pixel_mask[:, None]
    return {'pixel_values': pixels.astype(np.float32), 'pixel_mask': pixel_mask,
            'mask_labels': masks * pixel_mask[:, None],
            'class_labels': np.zeros((b, n), np.int32),
            'instance_valid': np.ones((b, n), np.float32),
            'sample_valid': np.ones((b,), np.float32)}


def _jax_factors(rng, b: int, cfg) -> dict:
    """The factors the JAX ``augment_batch`` draws from ``rng``."""
    k_flip, k_scale_on, k_scale, k_shift, k_bright, k_contrast = jax.random.split(rng, 6)
    flip = (jax.random.uniform(k_flip, (b,)) < cfg.hflip_prob).astype(jnp.float32)
    scale_on = jax.random.uniform(k_scale_on, (b,)) < cfg.scale_prob
    lo, hi = cfg.scale_range
    scale = jnp.where(scale_on, jax.random.uniform(k_scale, (b,), minval=lo, maxval=hi), 1.0)
    max_shift = jnp.maximum(1.0 - 1.0 / scale, 0.0)
    shift = jax.random.uniform(k_shift, (b, 2), minval=-1.0, maxval=1.0) * max_shift[:, None]
    bright = jax.random.uniform(k_bright, (b, 1, 1, 1), minval=1.0 - cfg.brightness,
                                maxval=1.0 + cfg.brightness)
    contrast = jax.random.uniform(k_contrast, (b, 1, 1, 1), minval=1.0 - cfg.contrast,
                                  maxval=1.0 + cfg.contrast)
    return {k: torch.from_numpy(np.array(v, np.float32)).reshape(b, *shape) for k, v, shape in (
        ('flip', flip, ()), ('scale', scale, ()), ('shift', shift, (2,)),
        ('brightness', bright, ()), ('contrast', contrast, ()))}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize('name', list(CONFIGS))
@pytest.mark.parametrize('seed', [0, 1])
def test_apply_factors_matches_jax(name, seed):
    """The port on the JAX factors: pixels within 1e-5, the masks, pixel
    mask and ``instance_valid`` exact, every other key passed through."""
    cfg = CONFIGS[name]
    batch = _batch(seed=seed)
    rng = jax.random.PRNGKey(10 + seed)
    want = jax_augment.augment_batch({k: jnp.asarray(v) for k, v in batch.items()}, rng,
                                     jax_augment.AugmentConfig(**vars(cfg)))
    got = apply_factors(_torch(batch), _jax_factors(rng, 4, cfg), cfg)
    assert set(got) == set(want)
    np.testing.assert_allclose(got['pixel_values'].numpy(), np.asarray(want['pixel_values']),
                               atol=1e-5)
    for key in ('mask_labels', 'pixel_mask', 'instance_valid'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ('class_labels', 'sample_valid'):
        assert got[key] is not None and torch.equal(got[key], _torch(batch)[key])


def test_disabled_is_passthrough():
    batch = _torch(_batch())
    assert augment_batch(batch, AugmentConfig(0.0, 0.0, (1.0, 1.0), 0.0, 0.0)) is batch


def test_hflip_mirrors_pixels_and_masks_together():
    batch = _torch(_batch(padded=False))
    cfg = AugmentConfig(hflip_prob=1.0, scale_prob=0.0, brightness=0.0, contrast=0.0)
    out = augment_batch(batch, cfg, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(out['pixel_values'].numpy(),
                               batch['pixel_values'].flip(-1).numpy(), atol=1e-5)
    assert torch.equal(out['mask_labels'], batch['mask_labels'].flip(-1))
    assert torch.equal(out['pixel_mask'], batch['pixel_mask'])


def test_masks_track_pixels_under_scale_jitter():
    """An image painted as its one mask: after any scale and shift, the
    nearest-sampled mask sits where the bilinear-sampled content is: they
    differ only on the mask's one-pixel rim (bilinear against nearest taps),
    and overlap by IoU above 0.8 (the JAX test's 0.85 holds for its own
    draws; these include zoom-outs to 0.7, where the rim of the shrunken
    rectangle is a larger share)."""
    mask = np.zeros((1, 1, 48, 48), np.float32)
    mask[:, :, 12:28, 8:30] = 1.0
    batch = {'pixel_values': torch.from_numpy(np.repeat(mask, 3, axis=1)),
             'pixel_mask': torch.ones(1, 48, 48), 'mask_labels': torch.from_numpy(mask),
             'instance_valid': torch.ones(1, 1)}
    cfg = AugmentConfig(hflip_prob=0.0, scale_prob=1.0, scale_range=(0.7, 1.4),
                        brightness=0.0, contrast=0.0)
    for seed in range(6):
        out = augment_batch(batch, cfg, torch.Generator().manual_seed(seed))
        img_raw = out['pixel_values'][0, 0].numpy() * STD[0] + MEAN[0]
        m = out['mask_labels'][0, 0].numpy()
        inter = ((img_raw > 0.5) & (m > 0.5)).sum()
        union = ((img_raw > 0.5) | (m > 0.5)).sum()
        assert union > 0 and inter / union > 0.8, f'seed {seed}: IoU {inter / union}'
        grown = torch.nn.functional.max_pool2d(torch.from_numpy(m)[None, None], 3, 1, 1)[0, 0]
        shrunk = -torch.nn.functional.max_pool2d(-torch.from_numpy(m)[None, None], 3, 1, 1)[0, 0]
        rim = (grown > 0.5) & (shrunk < 0.5)
        assert not ((img_raw > 0.5) ^ (m > 0.5))[~rim.numpy()].any(), f'seed {seed}'


def test_crop_clears_instance_valid_when_the_mask_vanishes():
    mask = np.zeros((1, 1, 40, 40), np.float32)
    mask[:, :, :3, :3] = 1.0
    batch = {'pixel_values': torch.zeros(1, 3, 40, 40), 'pixel_mask': torch.ones(1, 40, 40),
             'mask_labels': torch.from_numpy(mask), 'instance_valid': torch.ones(1, 1)}
    cfg = AugmentConfig(hflip_prob=0.0, scale_prob=1.0, scale_range=(3.0, 3.0),
                        brightness=0.0, contrast=0.0)
    vanished = False
    for seed in range(12):
        out = augment_batch(batch, cfg, torch.Generator().manual_seed(seed))
        iv = float(out['instance_valid'][0, 0])
        assert iv == (1.0 if out['mask_labels'][0, 0].sum() > 0 else 0.0)
        vanished |= iv == 0.0
    assert vanished


def test_brightness_is_raw_space_multiply():
    batch = _torch(_batch(padded=False))
    cfg = AugmentConfig(hflip_prob=0.0, scale_prob=0.0, brightness=0.4, contrast=0.0)
    out = augment_batch(batch, cfg, torch.Generator().manual_seed(7))
    raw_in = batch['pixel_values'].numpy() * STD + MEAN
    raw_out = out['pixel_values'].numpy() * STD + MEAN
    for k in range(raw_in.shape[0]):
        sel = (raw_out[k] > 1e-3) & (raw_out[k] < 0.999)
        ratio = raw_out[k][sel] / raw_in[k][sel]
        assert ratio.std() < 1e-4 and 0.6 - 1e-5 <= ratio.mean() <= 1.4 + 1e-5


def test_a_data_rank_draws_its_rows_of_the_global_factors():
    """Rank r of W keeps rows [r·b, (r+1)·b) of what one process draws for
    the global batch, from the same generator state."""
    cfg = AugmentConfig()
    whole = draw_factors(4, cfg, torch.Generator().manual_seed(3), torch.device('cpu'))
    for rank in (0, 1):
        part = draw_factors(2, cfg, torch.Generator().manual_seed(3), torch.device('cpu'),
                            shard=(rank, 2))
        for key, value in whole.items():
            assert torch.equal(part[key], value[2 * rank:2 * rank + 2]), key


def test_train_step_with_augmentation():
    """A tiny-test train step with the augmentation on: a finite loss that
    differs from the step without it, from the same draws."""
    batch = _torch(_batch(b=2, h=64, w=96, n=4, padded=True))
    batch['mask_labels'] = batch['mask_labels'].to(torch.uint8)
    losses = []
    for augment in (AugmentConfig(), None):
        model = build_model('tiny-test', num_labels=3, device='cpu', train=True, seed=0)
        step = make_train_step(model, model.config, make_optimizer(model.parameters(), 1e-4),
                               1, augment=augment)
        losses.append(float(step(batch)))
        assert all(p.grad is not None for p in model.parameters())
    assert np.isfinite(losses).all() and losses[0] != losses[1]


def test_from_env(monkeypatch):
    monkeypatch.delenv('WISTPU_AUGMENT', raising=False)
    assert from_env() is None
    monkeypatch.setenv('WISTPU_AUGMENT', '1')
    monkeypatch.setenv('WISTPU_AUG_BRIGHTNESS', '0.33')
    monkeypatch.setenv('WISTPU_AUG_SCALE_LO', '0.6')
    cfg = from_env()
    assert cfg.brightness == pytest.approx(0.33) and cfg.scale_range == (0.6, 1.25)
    assert cfg.hflip_prob == AugmentConfig().hflip_prob
