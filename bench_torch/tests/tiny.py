"""Cells at a size a CPU test run holds: the program's ``tiny-test`` Swin
(or the R50 at a small image) with the cell's own driver, float32."""

from __future__ import annotations

import dataclasses
import time

from weed_instance_segmentation_tpu_torch.models.configuration import (
    Mask2FormerConfig, SwinConfig,
)

from bench_torch import harness

TRAFFIC = {
    'train': {'image_hw': [96, 96], 'instance_hw': [16, 16], 'compute_dtype': 'float32'},
    'serve': {'image_hw': [80, 80], 'model_hw': [64, 64], 'pool': 3, 'check_requests': 2,
              'compute_dtype': 'float32'},
}


def config_dict(cfg: Mask2FormerConfig, arch: str) -> dict:
    d = dataclasses.asdict(cfg)
    d['backbone_config']['model_type'] = ('swin' if isinstance(cfg.backbone_config, SwinConfig)
                                          else 'resnet')
    d['arch'] = arch
    return d


R50 = config_dict(Mask2FormerConfig.resnet50(num_labels=5), 'resnet50')


def overrides(cell: str, config: dict | None = None, **traffic) -> dict:
    """A serving cell runs R50 (full width, small images) with ``config=R50``."""
    run = harness.Run(cell, 0, 1, False, 0.0)
    cfg = config or config_dict(Mask2FormerConfig.tiny_test(num_labels=5), 'tiny-test')
    return {'config': cfg, 'traffic': {**TRAFFIC[run.traffic['driver']], **traffic}}


def run(cell: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5, trace: bool = False,
        config: dict | None = None, **traffic) -> dict:
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device='cpu',
                            overrides=overrides(cell, config, **traffic))


def make_run(cell: str, seed: int = 2 ** 31 + 7, config: dict | None = None,
             **traffic) -> harness.Run:
    r = harness.Run(cell, seed, 0.5, False, time.perf_counter(), 'cpu',
                    overrides(cell, config, **traffic))
    r.open_device()
    return r


def numbers(cell: str, seed: int = 2 ** 31 + 7, config: dict | None = None,
            **traffic) -> tuple[dict, bool]:
    """Every number a small run of ``cell`` compares or prints, and whether
    it came out correct."""
    r = make_run(cell, seed, config, **traffic)
    harness.load_module('drivers', r.traffic['driver']).run(r)
    found = {k: v for k, (v, _) in r.checks.items()}
    found.update({k: v for k, v in r.notes.items() if isinstance(v, float)})
    return found, r.correct()
