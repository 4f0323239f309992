"""The plain reference against the program at a small size on the CPU,
float32: the same logits, and the same training step (drop path on, so
that the draws' order is held too)."""

import pytest
import torch

from weed_instance_segmentation_tpu_torch.engine import model_utils
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig

from bench_torch import compare
from bench_torch.reference.model import Mask2Former, Numerics, preprocess
from bench_torch.tests import tiny


@pytest.mark.parametrize('config, hw', [(None, (72, 88)), (tiny.R50, (64, 64))],
                         ids=['swin', 'r50'])
def test_forward_matches_the_program(config, hw):
    run = tiny.make_run('swinl-serve-b4', config=config)
    program = run.program_model(torch.float32).eval()
    reference = run.reference_model('cpu')
    reference.load_state_dict(run.state_dict(torch.float32))
    reference.eval()
    x = torch.randn(2, 3, *hw, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = program(x)
        class_logits, mask_logits = reference(x)
        fp8_class, _ = reference(x, Numerics('fp8'))
    want = [*out.aux_class_queries_logits, out.class_queries_logits]
    for got, ref in zip(class_logits, want):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    masks = [*out.aux_masks_queries_logits, out.masks_queries_logits]
    for got, ref in zip(mask_logits, masks):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert (fp8_class[-1] - class_logits[-1]).abs().max() > 1e-2  # the control differs


def test_preprocess_matches_the_program():
    from weed_instance_segmentation_tpu_torch.processing.fused import fused_preprocess

    raw = torch.randint(0, 256, (2, 100, 90, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4))
    got = preprocess(raw, (64, 72))
    want, _ = fused_preprocess(raw, (64, 72), (64, 72))
    torch.testing.assert_close(got, want, rtol=0, atol=1.01 / 255 / 0.224)
    assert (got - want).abs().gt(1e-5).float().mean() < 1e-3  # rounding ties only


def test_training_steps_match_the_program(monkeypatch):
    drop = Mask2FormerConfig.tiny_test(num_labels=5)
    drop.backbone_config.drop_path_rate = 0.3
    monkeypatch.setattr(model_utils, 'config_for_arch', lambda arch, **kw: drop)
    found, correct = tiny.numbers('swinl-train-b2', seed=2 ** 33 + 1,
                                  config=tiny.config_dict(drop, 'tiny-test'))
    assert found['loss_gap'] < 1e-5 and found['grad_gap'] < 1e-4, found
    assert found['change_gap'] < 1e-3, found
    assert correct


@pytest.mark.parametrize('config', [None, tiny.R50], ids=['swin', 'r50'])
def test_serving_answers_match_the_program(config):
    found, correct = tiny.numbers('swinl-serve-b4', config=config)
    assert correct and found['replay_diff'] == 0.0
    assert found['score_gap'] < 1e-4 and found['label_rms_request'] < 1e-4, found  # float32
    assert found['mask_gap'] < 1e-3 and found['cover_gap'] == 0.0, found


def test_gaps_read_the_worst_leaf():
    ref = {'losses': [2.0], 'grad': {'a': 1.0, 'b': 1.0, 'c': 1e-9},
           'change': {'a': 1.0, 'b': 1.0, 'c': 1.0}}
    prog = {'losses': [2.1], 'grad': {'a': 1.0, 'b': 1.2, 'c': 0.0},
            'change': {'a': 1.0, 'b': 0.5, 'c': 9.0}}
    gaps, where = compare.train_gaps(prog, ref)
    assert gaps['loss_gap'] == pytest.approx(0.05)
    assert gaps['grad_gap'] == pytest.approx(0.2) and where['grad_gap_leaf'] == 'b'
    assert gaps['change_gap'] == pytest.approx(0.5)  # the still leaf 'c' is left out
    assert where['still_leaves'] == 'c'
