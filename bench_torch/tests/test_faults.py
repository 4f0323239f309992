"""A whole run, on the CPU at a small size, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have, and
for decisions the reference follows (the decoder's attention masks, the
loss's uncertain points) made by another rule."""

import pytest
import torch
import torch.nn.functional as F

from weed_instance_segmentation_tpu_torch.engine import export, steps
from weed_instance_segmentation_tpu_torch.losses import criterion
from weed_instance_segmentation_tpu_torch.models import transformer_decoder

from bench_torch.tests import tiny


def _wrong(result: dict) -> None:
    assert not result['correct']
    assert any(c['value'] > c['limit'] for c in result['checks'].values()), result['checks']


def test_train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, 'step', lambda self, closure=None: None)
    _wrong(tiny.run('swinl-train-b2'))


def test_train_half_batch(monkeypatch):
    make = steps.make_loss_fn

    def half(*args, **kwargs):
        loss_fn = make(*args, **kwargs)
        return lambda batch, draws: loss_fn({k: v[:v.shape[0] // 2] for k, v in batch.items()},
                                            draws)

    monkeypatch.setattr(steps, 'make_loss_fn', half)
    _wrong(tiny.run('swinl-train-b2'))


def test_train_uniform_points(monkeypatch):
    sample = criterion._uncertainty_points

    def uniform(pred_masks, *args, **kwargs):  # every |logit| ties: the first candidates
        return sample(torch.zeros_like(pred_masks), *args, **kwargs)

    monkeypatch.setattr(criterion, '_uncertainty_points', uniform)
    _wrong(tiny.run('swinl-train-b2'))


@pytest.mark.parametrize('cell', ['swinl-train-b2', 'swinl-serve-b4'])
def test_attention_mask_by_nearest(monkeypatch, cell):
    monkeypatch.setattr(transformer_decoder, 'interpolate_bilinear',
                        lambda x, hw: F.interpolate(x, size=tuple(hw), mode='nearest'))
    _wrong(tiny.run(cell))


def _patched_post_process(monkeypatch, change):
    post = export.post_process_instance_arrays

    def patched(*args, **kwargs):
        res = post(*args, **kwargs)
        return res._replace(**change(res))

    monkeypatch.setattr(export, 'post_process_instance_arrays', patched)


def test_serve_answer_altered(monkeypatch):
    def lower_first_image(res):  # one image's answers altered where they are produced
        scores = res.scores.clone()
        scores[0] *= 0.9
        return {'scores': scores}

    _patched_post_process(monkeypatch, lower_first_image)
    _wrong(tiny.run('swinl-serve-b4'))


def test_serve_half_batch(monkeypatch):
    def first_half_twice(res):
        half = res.scores.shape[0] // 2
        return {k: torch.cat([getattr(res, k)[:half]] * 2)
                for k in ('segmentation', 'scores', 'valid', 'labels', 'segment_ids')}

    _patched_post_process(monkeypatch, first_half_twice)
    _wrong(tiny.run('swinl-serve-b4'))
