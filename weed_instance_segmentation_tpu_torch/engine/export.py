"""Serving function and its exported program: uint8 images in, instance
arrays out.

Port of ``weed_instance_segmentation_tpu/engine/export.py``. The serving
pipeline (:class:`ServingModule`, which :func:`make_serving_fn` runs in
its two halves)::

    uint8 image batch (B, H_in, W_in, 3) on the model's device
      → fused pre-process (processing/fused.py)
      → Mask2Former encoder half (backbone, pixel decoder)
      → Mask2Former decoder half (masked-attention decoder, class head)
      → instance post-process (processing/postprocess.py), in float32
      → fixed-shape result arrays (segmentation map, labels, scores, …)

:func:`export_serving` saves that pipeline as one ``torch.export`` program
with the weights inside; :func:`load_serving` loads it with no model code,
config or checkpoint: it needs torch and this package's ``ops`` modules,
which register the five kernels as operators (``torch.ops.wistpu.*``) and
build them at first use. The saved graph calls those operators, so a loaded
program launches the same kernels as the live function, and their launch
counters count them. Shapes are static (one artifact per batch and
resolution), and one artifact serves the device it was exported on.

On a CUDA device :func:`make_serving_fn` replays the request's encoder
half as one CUDA graph per input shape (a micro-batch's, where it splits
the request): the pre-process, the NHWC cast, the backbone and the pixel
decoder (``ServingModule.encode``). A shape's first request warms the
encoder up on a side stream (which builds the kernels and the device
constants) and captures the graph on that stream; it and every later
request of the shape copy their images into the graph's static input and
replay it. Each graph keeps a private memory pool of the encoder's
activations for as long as the serving function lives. The
masked-attention decoder, the class head and the post-process
(``ServingModule.decode``) run eagerly on the graph's static outputs, and
return fresh tensors, which a later replay never overwrites. A request runs
eagerly throughout, with neither capture nor replay, where its images are
on the CPU, where the model is in training mode, or while the autograd
profiler is enabled (a replay would hide each operator's name and shapes
from it). On a CUDA tensor outside those cases a capture that fails raises.
The graph holds the model's parameters by address: it serves the weights
the function was made with, and updates copied into them in place. The
serving function's ``graphs`` maps each (shape, dtype, device) to its
graph; calling one replays it outside the serving function, so a profiler
can see the replayed kernels.

Each call of a serving function is the span ``serve.request``
(``engine/trace.py``; its id the call's index). Inside it the live
function records ``serve.preprocess``, ``model.backbone`` and
``model.pixel_decoder`` where the encoder half runs eagerly (and in a
capture's warm-up and capture), ``serve.graph_replay`` around the copy in
and the replay, then ``model.decoder`` and ``serve.postprocess``. The
counters ``serve.graph.captures`` and ``serve.graph.replays`` count
captures and replays. A kernel's ``wistpu.<op>.launches`` counts only the
launches made where it runs; the launches a capture records count once,
under ``wistpu.<op>.captured`` (``ops/cuda_build.py::count_launch``), and
each replay makes them again.

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
from torch.autograd import profiler as _profiler

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
        return self.decode(*self.encode(raw))

    def encode(self, raw: torch.Tensor) -> tuple[torch.Tensor, list]:
        """The encoder half: the pre-process and ``model.encode``."""
        with trace.span('serve.preprocess'):
            pixel_values, _ = fused_preprocess(raw, self.out_hw, self.out_hw)
        return self.model.encode(pixel_values)

    def decode(self, mask_features: torch.Tensor, multi_scale: list) -> dict:
        """The decoder half: ``model.decode`` and the post-process."""
        out = self.model.decode(mask_features, multi_scale)
        with trace.span('serve.postprocess'):
            res = post_process_instance_arrays(
                out.class_queries_logits.float(), out.masks_queries_logits.float(),
                self.target_size, self.threshold, with_masks=self.emit_masks,
            )._asdict()
        if not self.emit_masks:
            res.pop('masks')
        return res


class _EncoderGraph:
    """``encode`` of one input shape as a CUDA graph: its static input, and
    the static outputs that each replay rewrites."""

    def __init__(self, encode: Callable, raw: torch.Tensor):
        """Warm ``encode`` up on ``raw`` on a side stream, then capture it on
        that stream."""
        current = torch.cuda.current_stream(raw.device)
        self.input = raw.clone()
        stream = torch.cuda.Stream(raw.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            encode(self.input)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.output = encode(self.input)
        current.wait_stream(stream)
        trace.count('serve.graph.captures')

    @torch.inference_mode()
    def __call__(self, raw: torch.Tensor) -> tuple[torch.Tensor, list]:
        """Copy ``raw`` into the static input and replay: the static
        outputs then hold ``encode(raw)``."""
        self.input.copy_(raw)
        self.graph.replay()
        trace.count('serve.graph.replays')
        return self.output


def make_serving_fn(model: torch.nn.Module, *, out_hw: tuple[int, int],
                    target_size: tuple[int, int] | None = None,
                    threshold: float = 0.5,
                    micro_batch: int = 0,
                    emit_masks: bool = True) -> Callable[[torch.Tensor], dict]:
    """(raw uint8 (B, H_in, W_in, 3)) → dict of InstanceSegmentationResult
    arrays, batch-leading, through :class:`ServingModule` in inference mode;
    on a CUDA device its encoder half replays as a CUDA graph (the module's
    docstring says when).

    ``micro_batch`` > 0 runs the request in sub-batches of that size, one
    after another, which caps activation memory at the sub-batch; the
    request batch must divide evenly.
    """
    one = ServingModule(model, out_hw=out_hw, target_size=target_size, threshold=threshold,
                        emit_masks=emit_masks)
    device = next(model.parameters()).device
    requests = itertools.count()
    graphs = {}  # (shape, dtype, device) → _EncoderGraph

    def encoded(raw: torch.Tensor) -> tuple[torch.Tensor, list]:
        if raw.device.type != 'cuda' or model.training or _profiler._is_profiler_enabled:
            return one.encode(raw)
        key = (tuple(raw.shape), raw.dtype, raw.device)
        if key not in graphs:
            graphs[key] = _EncoderGraph(one.encode, raw)
        with trace.span('serve.graph_replay'):
            return graphs[key](raw)

    def run(raw: torch.Tensor) -> dict:
        return one.decode(*encoded(raw))

    @torch.inference_mode()
    def serve(raw: torch.Tensor) -> dict:
        if raw.device != device:
            raise ValueError(f'images are on {raw.device}, the model on {device}')
        with trace.span('serve.request', id=next(requests)):
            b = raw.shape[0]
            if not micro_batch or b <= micro_batch:
                return run(raw)
            if b % micro_batch:
                raise ValueError(f'serving batch {b} not divisible by micro_batch {micro_batch}')
            parts = [run(chunk) for chunk in raw.split(micro_batch)]
            return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}

    serve.graphs = graphs
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
        attention_mask, deformable_attention, masked_attention, postprocess_kernel,
        window_attention,
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
