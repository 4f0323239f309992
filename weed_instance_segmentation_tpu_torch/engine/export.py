"""Serving function and its exported program: uint8 images in, instance
arrays out.

Port of ``weed_instance_segmentation_tpu/engine/export.py``. The serving
pipeline (:class:`ServingModule`, which :func:`make_serving_fn` calls
eagerly)::

    uint8 image batch (B, H_in, W_in, 3) on the model's device
      → fused pre-process (processing/fused.py)
      → Mask2Former forward
      → instance post-process (processing/postprocess.py), in float32
      → fixed-shape result arrays (segmentation map, labels, scores, …)

:func:`export_serving` saves that pipeline as one ``torch.export`` program
with the weights inside; :func:`load_serving` loads it with no model code,
config or checkpoint: it needs torch and this package's ``ops`` modules,
which register the four kernels as operators (``torch.ops.wistpu.*``) and
build them at first use. The saved graph calls those operators, so a loaded
program launches the same kernels as the live function, and their launch
counters count them. Shapes are static (one artifact per batch and
resolution), and one artifact serves the device it was exported on.

Each call of a serving function is the span ``serve.request``
(``engine/trace.py``; its id the call's index); inside it the live
function's ``serve.preprocess``, the model's spans and ``serve.postprocess``.

Artifact layout under ``<out_dir>/``:
    serving.pt2    — ``torch.export.save`` of the program, weights included
    manifest.json  — shapes, dtypes, arch, threshold, platform, torch version

CLI (env-driven like every entry point)::

    WISTPU_EXPORT_CHECKPOINT=<dir>  model directory (engine/checkpoint.py
                                    save_pretrained layout); unset = random
                                    init of WISTPU_MODEL_ARCH (swin-large)
    WISTPU_EXPORT_DIR=<dir>         output dir (default output/serving)
    WISTPU_EXPORT_BATCH (4), WISTPU_EXPORT_HW_IN (1024), WISTPU_EXPORT_HW
    (800), WISTPU_EXPORT_THRESHOLD (0.5), WISTPU_EXPORT_MASKS (1),
    WISTPU_COMPUTE_DTYPE (bfloat16), WISTPU_NUM_LABELS (5); the card unless
    WISTPU_DEVICE=cpu.

    python -m weed_instance_segmentation_tpu_torch.engine.export
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Callable

import torch

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.processing.fused import fused_preprocess
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    post_process_instance_arrays,
)

ARTIFACT_NAME = 'serving.pt2'
MANIFEST_NAME = 'manifest.json'


class ServingModule(torch.nn.Module):
    """(raw uint8 (B, H_in, W_in, 3)) → dict of InstanceSegmentationResult
    arrays, batch-leading, for one batch in one pass.

    ``out_hw`` is the model input resolution after the pre-process;
    ``target_size`` the resolution of the returned segmentation maps
    (defaults to ``out_hw``). ``emit_masks=False`` drops the (B, Q, H, W)
    per-instance masks: the int32 id map and the per-slot arrays describe
    the non-overlapping output."""

    def __init__(self, model: torch.nn.Module, *, out_hw: tuple[int, int],
                 target_size: tuple[int, int] | None = None, threshold: float = 0.5,
                 emit_masks: bool = True):
        super().__init__()
        self.model = model
        self.out_hw = tuple(out_hw)
        self.target_size = tuple(target_size or out_hw)
        self.threshold = threshold
        self.emit_masks = emit_masks

    def forward(self, raw: torch.Tensor) -> dict:
        with trace.span('serve.preprocess'):
            pixel_values, _ = fused_preprocess(raw, self.out_hw, self.out_hw)
        out = self.model(pixel_values)
        with trace.span('serve.postprocess'):
            res = post_process_instance_arrays(
                out.class_queries_logits.float(), out.masks_queries_logits.float(),
                self.target_size, self.threshold, with_masks=self.emit_masks,
            )._asdict()
        if not self.emit_masks:
            res.pop('masks')
        return res


def make_serving_fn(model: torch.nn.Module, *, out_hw: tuple[int, int],
                    target_size: tuple[int, int] | None = None,
                    threshold: float = 0.5,
                    micro_batch: int = 0,
                    emit_masks: bool = True) -> Callable[[torch.Tensor], dict]:
    """(raw uint8 (B, H_in, W_in, 3)) → dict of InstanceSegmentationResult
    arrays, batch-leading, through :class:`ServingModule` in inference mode.

    ``micro_batch`` > 0 runs the request in sub-batches of that size, one
    after another, which caps activation memory at the sub-batch; the
    request batch must divide evenly.
    """
    one = ServingModule(model, out_hw=out_hw, target_size=target_size, threshold=threshold,
                        emit_masks=emit_masks)
    device = next(model.parameters()).device
    requests = itertools.count()

    @torch.inference_mode()
    def serve(raw: torch.Tensor) -> dict:
        if raw.device != device:
            raise ValueError(f'images are on {raw.device}, the model on {device}')
        with trace.span('serve.request', id=next(requests)):
            b = raw.shape[0]
            if not micro_batch or b <= micro_batch:
                return one(raw)
            if b % micro_batch:
                raise ValueError(f'serving batch {b} not divisible by micro_batch {micro_batch}')
            parts = [one(chunk) for chunk in raw.split(micro_batch)]
            return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}

    return serve


def export_serving(
    model: torch.nn.Module,
    out_dir: str,
    *,
    batch: int,
    in_hw: tuple[int, int],
    out_hw: tuple[int, int],
    target_size: tuple[int, int] | None = None,
    threshold: float = 0.5,
    manifest_extra: dict | None = None,
    emit_masks: bool = True,
) -> str:
    """Export the serving pipeline of ``model`` for uint8 (batch, *in_hw, 3)
    on the model's device, and save it with its manifest under ``out_dir``;
    returns the artifact path.

    The program is traced by ``torch.export`` (non-strict) under
    ``torch.no_grad``, with the model in eval mode and its parameters'
    ``requires_grad`` off (both restored afterwards), and saved with the
    weights inside."""
    device = next(model.parameters()).device
    module = ServingModule(model, out_hw=out_hw, target_size=target_size, threshold=threshold,
                           emit_masks=emit_masks)
    example = torch.zeros((batch, *in_hw, 3), dtype=torch.uint8, device=device)
    training, flags = model.training, [p.requires_grad for p in model.parameters()]
    model.eval().requires_grad_(False)
    try:
        with torch.no_grad():
            program = torch.export.export(module, (example,), strict=False)
    finally:
        model.train(training)
        for p, flag in zip(model.parameters(), flags):
            p.requires_grad_(flag)

    os.makedirs(out_dir, exist_ok=True)
    artifact = os.path.join(out_dir, ARTIFACT_NAME)
    torch.export.save(program, artifact)
    manifest = {
        'input': {'shape': [batch, *in_hw, 3], 'dtype': 'uint8',
                  'layout': 'BHWC raw images'},
        'model_input_hw': list(out_hw),
        'target_size': list(target_size or out_hw),
        'threshold': threshold,
        'platforms': [device.type],
        'torch_version': torch.__version__,
        'emit_masks': emit_masks,
        'outputs': 'InstanceSegmentationResult fields (batch-leading)'
                   + ('' if emit_masks else ', masks omitted (id map only)'),
        **(manifest_extra or {}),
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), 'w') as f:
        json.dump(manifest, f, indent=2)
    return artifact


def load_serving(out_dir: str) -> tuple[Callable, dict]:
    """Load an exported artifact → (callable(raw uint8) → result dict,
    manifest); the callable runs in inference mode, and its ``program`` is
    the loaded ``GraphModule``. Needs torch and this package's ``ops``
    modules (which register the kernels' operators), no model code, config
    or checkpoint. Raises where the artifact's device is not available."""
    from weed_instance_segmentation_tpu_torch.ops import (  # noqa: F401  (registers the ops)
        deformable_attention, masked_attention, postprocess_kernel, window_attention,
    )

    with open(os.path.join(out_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if 'cuda' in manifest['platforms'] and not torch.cuda.is_available():
        raise RuntimeError(f'{out_dir} was exported for {manifest["platforms"]}; no CUDA '
                           'device is available')
    program = torch.export.load(os.path.join(out_dir, ARTIFACT_NAME)).module()
    requests = itertools.count()

    @torch.inference_mode()
    def serve(raw: torch.Tensor) -> dict:
        with trace.span('serve.request', id=next(requests)):
            return program(raw)

    serve.program = program
    return serve, manifest


def main() -> None:
    from weed_instance_segmentation_tpu_torch.engine.checkpoint import load_pretrained
    from weed_instance_segmentation_tpu_torch.engine.model_utils import (
        build_model, model_from_state_dict,
    )

    ckpt = os.environ.get('WISTPU_EXPORT_CHECKPOINT')
    out_dir = os.environ.get('WISTPU_EXPORT_DIR', os.path.join('output', 'serving'))
    batch = int(os.environ.get('WISTPU_EXPORT_BATCH', '4'))
    hw_in = int(os.environ.get('WISTPU_EXPORT_HW_IN', '1024'))
    hw = int(os.environ.get('WISTPU_EXPORT_HW', '800'))
    threshold = float(os.environ.get('WISTPU_EXPORT_THRESHOLD', '0.5'))
    emit_masks = os.environ.get('WISTPU_EXPORT_MASKS', '1') == '1'
    dtype_name = os.environ.get('WISTPU_COMPUTE_DTYPE', 'bfloat16')
    dtype = getattr(torch, dtype_name)
    device = os.environ.get('WISTPU_DEVICE', 'cuda')

    if ckpt:
        cfg, state_dict = load_pretrained(ckpt)
        model = model_from_state_dict(cfg, state_dict, dtype, device)
        arch = f'checkpoint:{ckpt}'
    else:
        arch = os.environ.get('WISTPU_MODEL_ARCH', 'swin-large')
        model = build_model(arch, int(os.environ.get('WISTPU_NUM_LABELS', '5')), dtype, device)

    artifact = export_serving(
        model, out_dir,
        batch=batch, in_hw=(hw_in, hw_in), out_hw=(hw, hw), threshold=threshold,
        emit_masks=emit_masks,
        manifest_extra={'arch': arch, 'compute_dtype': dtype_name},
    )
    size_mb = os.path.getsize(artifact) / 1e6
    print(f'exported {artifact} ({size_mb:.1f} MB) for {torch.device(device).type}')


if __name__ == '__main__':
    main()
