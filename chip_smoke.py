"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero on any failure):

1. the card: name and power limit;
2. build the four CUDA libraries from ``weed_instance_segmentation_tpu_torch/
   csrc`` (one ``nvcc`` each, started together, into the package's ``build/``);
3. each kernel against its plain PyTorch version, with times (CUDA events,
   medians, in turns with the plain version and one PyTorch library call;
   and each one's device-busy time per call from a ``torch.profiler`` trace,
   which leaves out the host's time between launches):
   the post-process kernel at the serving shape, twice on the same logits
   for the same bits, with each of its two launches' device µs, its achieved
   GB/s and its share of the byte bound; window attention forward
   and backward at Swin-L training batch 2, stage 1 (NW 578, H 6, T 144,
   D 32) and stage 3 (NW 50, H 24), with and without the shift mask, f32
   and bf16, the backward twice on the same inputs for the same bits, and
   the bf16 forward alone at the serving batch 4 (NW 1156 and 100), each
   stage's times under ``by_stage`` in the summary; masked attention
   forward and backward at B 2, H 8, Q 200, D 32, S in {10000, 2500, 625}
   (f32 on the CUDA-core kernels, bf16 on the tensor-core kernels, forward
   and backward), each level's times under ``by_s`` in the summary, and the
   bf16 forward at the serving batch (B 4, S 10000) under
   ``serving_b4_s10000``; the MSDA forward kernel at the serving shape
   (value (4, 13125, 8, 32) bf16, 13125 queries, 3 levels, 4 points): the
   plain version's bits, the same bits from two calls, its times against
   the plain version's and its byte bound; and the MSDA value gradient at
   the training shape (value (2, 13125, 8, 32) bf16): its fixed-order
   float32 sums the same bits over 10 calls and through two backward
   calls, and their device ms;
4. serving: Swin-L Mask2Former, 800², batch 4, bf16, random seeded weights;
   a first request that captures the encoder's CUDA graph (24
   window-attention and 6 MSDA launches recorded, and run by a profiled
   replay, by kernel name), then 3 requests of uint8 (4, 1024, 1024, 3)
   through ``make_serving_fn``, each replaying once and launching 9
   masked-attention and 1 post-process forward kernels itself, the first
   with the eager request's bits; then one more request whose 9 decoder masked-attention
   calls are recorded, each held against the plain version on its real
   inputs and masks;
5. training: Swin-L 800² batch 2, bf16 autocast over float32 parameters,
   gradient accumulation 2, remat, AdamW lr 5e-5, fed from a synthetic
   ``.npz`` cache through ``PreprocessedDataset`` → ``make_train_collate`` →
   ``DataLoader`` → the card; 2 warm-up and 6 timed micro-steps, each with a
   finite loss that launches both attention kernels forward and backward,
   parameters untouched on accumulation-only steps and changed on updates;
   then a ``torch.profiler`` trace of two more: the device's idle share,
   device time by kernel, and the split into the train step's own ranges
   (forward, criterion with the host matching, backward, optimizer);
6. evaluation: Swin-L with random seeded weights saved by ``save_pretrained``
   into a model directory, a synthetic ``.npz`` ``Test`` cache of 8 images
   (800² pixels from 1024² originals, 10 instances each), then
   ``engine.test.test_model`` at batch 2 with ``COMPUTE_DTYPE`` bfloat16,
   which computes in float32 as the JAX entry point does (the f32 attention
   kernels), and one more
   ``test_with_metrics`` at threshold 0.0 over the same cache (every
   covering slot reaches the IoU product and the matching); each run's
   img/s, peak memory, the split of its time (ground truth, forward,
   post-process, host reformat, IoU product, matching, other) and the
   launches of each kernel, which must be 24 window-attention and 9
   masked-attention forwards a batch and one post-process an image; then
   one batch's forward alone (event-timed, and its device-busy time by
   kernel) and one image's post-process at the 1024² target (device time,
   the kernel's share); then inference on the same model directory, loaded
   by ``load_model`` in bf16, with class 0's bias raised and the mask
   embedder sharpened so that slots pass the 0.5 threshold:
   ``run_inference_array`` on 1 warm-up and 4 timed 800² uint8 images (each
   an (800, 800) id map with valid segments, at least one kept),
   ``score_images`` over the 8-image cache (8 per-image mAPs in ascending
   order), each kernel's launches equal to 24 window-attention, 9
   masked-attention, 6 MSDA and 1 post-process forwards an image, a split of one
   image's time by stage, that image's bf16 logits post-processed on the
   card and on the CPU (the same segments), both attention kernels' bf16
   forwards against their plain versions at the path's batch-1 shapes
   (masked at S 10000, 2500, 625; window shifted at stage 1, NW 289, H 6,
   and stage 3, NW 25, H 24), and a tiny-test image through
   ``run_inference_array`` on the card against the CPU in float32, its bf16
   logits through the post-process on both;
7. tiny-test in float32 on the card against the same model on the CPU (the
   plain path): the serving function, one train step with the same random
   draws, and ``test_with_metrics`` at threshold 0.0 over a small cache
   (the metric dicts equal, or within 0.01 where bins flipped at zero
   crossings, which are printed); and ``mask_iou_matrix`` on 100 x 1024²
   against 20 x 1024² masks, the same bits on the card and the CPU;
8. trainer: ``engine.train.main()`` on the card, Swin-L from scratch (random
   seeded weights), bf16, batch 2, accumulation 2, remat, 1 epoch over a
   pheno_bench-style ``.npz`` cache (Train 8 and Validate 2 at 800² with 10
   instances each, Test 4 from 1024² originals): the metadata's keys and a
   finite history, ``best_model/``, ``final_model/`` and ``train_state/``
   written and ``best_model/`` read back, the float32 test phase's metric
   dict, and each kernel's launches equal to what the loops imply (4
   micro-steps, 1 validation and 2 test batches, 4 test images); the
   epoch's img/s and input duty cycle, each save's seconds and size, the
   test phase's img/s and peak memory. Then at tiny-test, 1 epoch and a
   ``WISTPU_RESUME`` on to 2: history epochs [1, 2], micro-steps 2 then 4;
   and a ``WISTPU_PROFILE`` run whose ``device_duty_profiled`` is recorded;
9. serving export (``phase_export``): Swin-L (200 queries) and
   Mask2Former-R50 (100 queries), 1024² uint8 → 800², batch 4, bf16, random
   seeded weights made to keep slots: ``export_serving`` (seconds, MiB),
   ``load_serving`` in a fresh ``python3`` that cannot import the port's
   ``models`` (5 requests, each launching window forward 24 / 0, masked
   forward 9, MSDA 6 and post-process 1), the outputs of that process and of the
   program loaded here equal to the live ``make_serving_fn``'s (scores
   within 1e-5), and the loaded program's and the live function's median
   ms a request, img/s and peak memory, timed in turns.
10. data parallelism (``phase_data_parallel``, in phase_trainer's directory):
   ``engine.train.main()`` as two processes sharing the card over ``gloo``
   (workers: ``python3 chip_smoke.py --data-parallel-rank <json>``),
   ``DATA_PARALLEL=2``, Swin-L 800² bf16, ``BATCH_SIZE`` 4 (2 a rank),
   accumulation 2, remat, one epoch over phase_trainer's cache: the
   averaged first loss against one process on the same global batch (rtol
   ``DP_LOSS_RTOL``), each rank's launches equal to the loops' count (the
   sharded test phase's post-process included), the metadata and metric
   dict, and every file of the run written by rank 0 alone; each rank's
   micro-step ms, epoch img/s and peak memory. Then one micro-step with the
   ``WISTPU_AUGMENT`` recipe and the augmentation at
   b2 800² on the card against the CPU on the same factors.

The last lines are a JSON summary of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch import roofline
from bench_torch.tracing import Slice, capture
from weed_instance_segmentation_tpu_torch import config
from weed_instance_segmentation_tpu_torch.datasets.crop_weed import definitions as crop_weed
from weed_instance_segmentation_tpu_torch.datasets.pheno_bench import definitions as pheno_bench
from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import (
    TRAIN_SAMPLE_KEYS, PreprocessedDataset, Subset, collate_fn, make_train_collate,
    process_and_save,
)
from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader, device_batches, to_device
from weed_instance_segmentation_tpu_torch.engine import checkpoint as ckpt
from weed_instance_segmentation_tpu_torch.engine import metrics
from weed_instance_segmentation_tpu_torch.engine import test as engine_test
from weed_instance_segmentation_tpu_torch.engine import train as engine_train
from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.engine.checkpoint import load_pretrained, save_pretrained
from weed_instance_segmentation_tpu_torch.engine.export import (
    ServingModule, export_serving, load_serving, make_serving_fn,
)
from weed_instance_segmentation_tpu_torch.engine.inference import run_inference_array
from weed_instance_segmentation_tpu_torch.engine.model_utils import (
    build_model, config_for_arch, load_model, resolve_model_path,
)
from weed_instance_segmentation_tpu_torch.engine.show_worst_predictions import score_images
from weed_instance_segmentation_tpu_torch.engine.steps import (
    make_forward_fn, make_optimizer, make_train_step,
)
from weed_instance_segmentation_tpu_torch.evaluation import mean_ap
from weed_instance_segmentation_tpu_torch.losses.criterion import PointDraws
from weed_instance_segmentation_tpu_torch.models import transformer_decoder
from weed_instance_segmentation_tpu_torch.models.pixel_decoder import reference_points_constant
from weed_instance_segmentation_tpu_torch.models.swin import shifted_window_attn_mask
from weed_instance_segmentation_tpu_torch.ops import deformable_attention
from weed_instance_segmentation_tpu_torch.ops import masked_attention as masked_attention_ops
from weed_instance_segmentation_tpu_torch.ops import postprocess_kernel as postprocess_kernel_ops
from weed_instance_segmentation_tpu_torch.ops import window_attention as window_attention_ops
from weed_instance_segmentation_tpu_torch.ops.cuda_build import build_libraries, build_log, captured
from weed_instance_segmentation_tpu_torch.ops.masked_attention import (
    masked_attention, masked_attention_plain,
)
from weed_instance_segmentation_tpu_torch.ops.postprocess_kernel import (
    fused_upsample_stats, fused_upsample_stats_plain, upsample_plain,
)
from weed_instance_segmentation_tpu_torch.ops.resize import nearest_indices
from weed_instance_segmentation_tpu_torch.ops.window_attention import (
    window_attention, window_attention_plain,
)
from weed_instance_segmentation_tpu_torch.processing.fused import fused_preprocess
from weed_instance_segmentation_tpu_torch.processing.image_processor import (
    Mask2FormerImageProcessor,
)
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    SCORE_RESOLUTION, class_probabilities, post_process_instance_arrays,
)

# the ops modules of the hand-written kernels: each names its library
# (csrc/<library>.cu) and its kernels' launch counters (engine/trace.py),
# 'wistpu.<kernel>.launches', forward and backward
KERNEL_OPS = (postprocess_kernel_ops, window_attention_ops, masked_attention_ops,
              deformable_attention)
LIBRARIES = tuple(op._LIBRARY for op in KERNEL_OPS)
_OWNED = [(counter.removeprefix('wistpu.').removesuffix('.launches'), counter, op._LIBRARY)
          for op in KERNEL_OPS
          for counter in (op.LAUNCHES, getattr(op, 'BACKWARD_LAUNCHES', None)) if counter]
LAUNCH_COUNTERS = {kernel: counter for kernel, counter, _ in _OWNED}
KERNEL_LIBRARY = {kernel: library for kernel, _, library in _OWNED}
KERNELS = {  # name → the TPU kernel it replaces
    'fused_upsample_stats': 'weed_instance_segmentation_tpu/ops/postprocess_kernel.py:88',
    'window_attention_fwd': 'tools/ab_window_attn.py:52',
    'window_attention_bwd': 'tools/ab_window_attn.py:52',
    'masked_attention_fwd': 'tools/ab_masked_attn.py:71',
    'masked_attention_bwd': 'tools/ab_masked_attn.py:71',
    'msda_fwd': 'none: the JAX package samples with XLA '
                '(weed_instance_segmentation_tpu/ops/msda_select.py)',
}
SERVING_BATCH, SERVING_IN, SERVING_HW, REQUESTS = 4, 1024, 800, 3
TRAIN_BATCH, TRAIN_HW, TRAIN_INSTANCES, TRAIN_LABELS = 2, 800, 10, 5
WARMUP_STEPS, TIMED_STEPS, ACCUMULATION, LEARNING_RATE = 2, 6, 2, 5e-5
STEP_RANGES = ('forward', 'criterion', 'backward', 'optimizer')  # engine/steps.py
EVAL_IMAGES, EVAL_BATCH, EVAL_ORIGINAL, EVAL_INSTANCES = 8, 2, 1024, 10
EVAL_MODEL_ID = 'mask2former_fine_tuned/latest/best_model/'
TIMED_RUNS = 25


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f'check failed: {msg}')


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def timed_in_turns(fns: dict, runs: int = TIMED_RUNS) -> dict:
    """Median ms of each function, after 3 warm-up calls each, the functions
    called in turns (order rotated every run)."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(runs):
        for name in names[r % len(names):] + names[:r % len(names)]:
            times[name].append(time_ms(fns[name]))
    return {name: statistics.median(ts) for name, ts in times.items()}


def profiled(prof) -> Slice:
    """The parsed trace of a stopped ``torch.profiler`` run
    (``bench_torch/tracing.py``)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            return Slice(json.load(f)['traceEvents'], 0.0, 1)


def device_split(fn, runs: int = 10, attempts: int = 3) -> collections.Counter:
    """Device-busy ms per call of ``fn`` by kernel (copies and fills
    included), from a ``torch.profiler`` trace of ``runs`` calls. Unlike
    ``time_ms`` it leaves out the host's time between launches. The profiler
    now and then returns a trace with no device events at all; such a trace
    is taken again, up to ``attempts`` times in all, and then this raises."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        split = collections.Counter()
        for _, dur, name, *_ in profiled(prof).device:
            split[name] += dur / 1e3 / runs
        if split:
            return split
        log(f'  (profiler trace {attempt + 1} held no device events; tracing again)')
    raise RuntimeError(f'{attempts} profiler traces held no device events')


def device_ms(fn, runs: int = 10) -> float:
    """Device-busy ms per call of ``fn`` (see ``device_split``)."""
    return sum(device_split(fn, runs).values())


def roofline_bound(work: tuple, dtype: str) -> dict:
    """The least ms the card could take for ``work`` (bytes, FLOPs in
    ``dtype``; ``bench_torch/roofline.py``), and which of the two sets it."""
    bytes_moved, flops = work
    by_bytes = bytes_moved / roofline.HBM_BYTES_PER_S >= flops / roofline.PEAK_FLOPS[dtype]
    return {'bound_ms': 1e3 * roofline.bound_s(bytes_moved, flops, dtype),
            'bound_by': 'bytes' if by_bytes else 'operations'}


_counted = dict.fromkeys(LAUNCH_COUNTERS, 0)  # each launch counter at the last reset_counts()


def reset_counts() -> None:
    _counted.update({key: trace.counter(name) for key, name in LAUNCH_COUNTERS.items()})


def counts() -> dict:
    """Each kernel's launches since the last :func:`reset_counts`."""
    return {key: trace.counter(name) - _counted[key] for key, name in LAUNCH_COUNTERS.items()}


def captured_counts() -> dict:
    """Each kernel's launches recorded by CUDA graph captures so far."""
    return {key: trace.counter(captured(name)) for key, name in LAUNCH_COUNTERS.items()}


def replayed_kernels(replay, raw: torch.Tensor) -> collections.Counter:
    """The device kernels one call of ``replay(raw)`` runs, by function name,
    from a profiler trace (a serving function's graph called directly: under
    a profiler the serving function itself runs eagerly)."""
    ran = capture(lambda: replay(raw), 1, torch.cuda.synchronize).device
    return collections.Counter(kernel_name(name) for _, _, name, *_ in ran
                               if not name.startswith('Memcpy') and not name.startswith('Memset'))


def check_postprocess(logits: torch.Tensor, outputs: tuple) -> tuple[int, float]:
    """The post-process kernel's outputs against the plain version on the
    same logits: a bin may flip only at a zero crossing (|up| within float32
    summation noise), pos_cnt exact and sig_sum within rtol 1e-5 once each
    flip is accounted. Returns (flips, sig_sum's largest abs error)."""
    sig, cnt, bins = outputs
    p_sig, p_cnt, p_bins = fused_upsample_stats_plain(logits, SCORE_RESOLUTION)
    up = upsample_plain(logits, SCORE_RESOLUTION)
    torch.cuda.synchronize()
    flip = bins != p_bins
    n_flips = int(flip.sum())
    if n_flips:
        check(up[flip].abs().max().item() <= 1e-5, 'a bin flipped away from a zero crossing')
    # account each flip exactly: its pixel moves in or out of both sums
    delta = (bins.float() - p_bins.float()) * flip
    check(torch.equal(cnt, p_cnt + delta.sum(dim=(-1, -2))), 'pos_cnt beyond the flips')
    p_sig_adj = p_sig + (delta * torch.sigmoid(up)).sum(dim=(-1, -2))
    err = (sig - p_sig_adj).abs()
    check(bool((err <= 1e-5 * p_sig_adj.abs()).all()), 'sig_sum beyond rtol 1e-5')
    return n_flips, err.max().item()


def postprocess_logits(dev: torch.device) -> torch.Tensor:
    """Mask logits at the serving shape: (4, 200, 200, 200) f32."""
    g = torch.Generator(device=dev).manual_seed(0)
    return torch.randn((SERVING_BATCH, 200, SERVING_HW // 4, SERVING_HW // 4), generator=g,
                       device=dev) * 2


def phase_postprocess_kernel(dev: torch.device) -> dict:
    """Kernel vs plain version at the serving shape, the same bits from two
    calls, and each launch's device time against the byte bound."""
    logits = postprocess_logits(dev)
    first = fused_upsample_stats(logits, SCORE_RESOLUTION)
    n_flips, err = check_postprocess(logits, first)
    log(f'post-process kernel vs plain at {tuple(logits.shape)} -> {SCORE_RESOLUTION}: '
        f'{n_flips} bin flips at zero crossings, sig_sum max abs err {err:.3e}, '
        f'pos_cnt exact after flips')
    second = fused_upsample_stats(logits, SCORE_RESOLUTION)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          'two post-process calls gave different bits')
    log('post-process kernel: two calls give the same bits of sig_sum, pos_cnt and bins')
    del first, second

    t = timed_in_turns({'plain': lambda: fused_upsample_stats_plain(logits, SCORE_RESOLUTION),
                        'kernel': lambda: fused_upsample_stats(logits, SCORE_RESOLUTION)})
    work = roofline.postprocess(*logits.shape, SCORE_RESOLUTION)
    moved, bound_ = work[0], roofline_bound(work, 'float32')
    split = device_split(lambda: fused_upsample_stats(logits, SCORE_RESOLUTION))
    dev_ms = sum(split.values())
    plain_dev_ms = device_ms(lambda: fused_upsample_stats_plain(logits, SCORE_RESOLUTION))
    log(f'post-process kernel {t["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms (medians of '
        f'{TIMED_RUNS}); device busy {dev_ms:.4f} / {plain_dev_ms:.4f} ms; moves '
        f'{moved / 1e6:.1f} MB = {moved / dev_ms / 1e6:.1f} GB/s on the device, '
        f'{bound_["bound_ms"] / dev_ms:.3f} of the byte bound {bound_["bound_ms"]:.4f} ms')
    log('  per launch: ' + '; '.join(f'{kernel_name(key)} {1e3 * ms:.2f} µs'
                                     for key, ms in split.most_common()))
    return {'max_abs_err': err, 'ms': t['kernel'], 'plain_ms': t['plain'], **bound_,
            'library_ms': None, 'device_ms': dev_ms, 'plain_device_ms': plain_dev_ms,
            'library_device_ms': None,
            'launch_device_us': {kernel_name(key): 1e3 * ms for key, ms in split.items()}}


def _rel_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    err = (got.float() - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def _check_against_plain(name, kernel, plain, qkv, extra, grad_extra, consts, dtype, tol):
    """Kernel and plain version under autograd on the same values (q/k/v in
    ``dtype``; the plain version computes in f32): forward output and every
    gradient within ``tol`` of the plain result's largest magnitude. Returns
    (output max abs err, gradients max abs err)."""
    ins = [t.detach().clone().to(dtype).requires_grad_(True) for t in qkv] + \
        [t.clone().requires_grad_(grad_extra) for t in extra]
    ref = [t.detach().float().requires_grad_(t.requires_grad) for t in ins]
    out = kernel(*ins, *consts)
    want = plain(*ref, *consts)
    cot = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(9),
                      device=out.device).to(dtype)
    out.backward(cot)
    want.backward(cot.float())
    torch.cuda.synchronize()
    out_err = _rel_errors(out, want)
    grad_errs = [_rel_errors(a.grad, b.grad) for a, b in zip(ins, ref) if a.requires_grad]
    worst = max([out_err[1]] + [e[1] for e in grad_errs])
    log(f'  {name} {str(dtype)[6:]}: out rel err {out_err[1]:.2e}, grads rel err '
        f'{", ".join(f"{e[1]:.2e}" for e in grad_errs)} (tolerance {tol:g})')
    check(worst <= tol, f'{name} {dtype}: {worst:.3e} beyond {tol}')
    return out_err[0], max(e[0] for e in grad_errs)


def _time_fwd_bwd(kernel, plain, library, inputs, consts, lib_args) -> dict:
    """Median ms of the forward and of the backward (``autograd.grad`` over a
    kept graph, gradients of every tensor in ``inputs``) for the kernel, the
    plain version and the library call (on q, k, v only, with ``lib_args``),
    and under ``device`` each one's device-busy ms per call."""
    def backward(fn, args):
        ins = [t.detach().requires_grad_(True) for t in args]
        out = fn(*ins)
        cot = torch.randn_like(out)
        return lambda: torch.autograd.grad(out, ins, cot, retain_graph=True)

    fns = {'plain': lambda *a: plain(*a, *consts), 'kernel': lambda *a: kernel(*a, *consts)}
    lib = lambda q_, k_, v_: library(q_, k_, v_, *lib_args)  # noqa: E731
    calls = {'fwd': {**{n: functools.partial(f, *inputs) for n, f in fns.items()},
                     'library': functools.partial(lib, *inputs[:3])},
             'bwd': {**{n: backward(f, inputs) for n, f in fns.items()},
                     'library': backward(lib, inputs[:3])}}
    result = {}
    for phase, c in calls.items():
        split = device_split(c['kernel'])
        log(f'  {phase} kernel launches, device ms per call: '
            + ', '.join(f'{kernel_name(k)} {ms:.4f}' for k, ms in split.most_common()))
        result[phase] = {**timed_in_turns(c), 'device': {
            'kernel': sum(split.values()), 'plain': device_ms(c['plain']),
            'library': device_ms(c['library'])}}
    return result


def kernel_name(key: str) -> str:
    """A kernel's function name from the profiler's signature."""
    name = re.search(r'(\w+)(<[^()]*>)?\(', key)
    return name.group(1) if name else key[:60]


def _summary(t: dict, bound_: dict, err: float) -> dict:
    """A kernel's entry of the summary line from one phase of
    ``_time_fwd_bwd``."""
    dev = t['device']
    return {'max_abs_err': err, 'ms': t['kernel'], 'plain_ms': t['plain'], **bound_,
            'library_ms': t['library'], 'device_ms': dev['kernel'],
            'plain_device_ms': dev['plain'], 'library_device_ms': dev['library']}


def _sdpa(scale):
    def call(q, k, v, attn_mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)
    return call


def _forward_err(what: str, kernel, plain, qkv, consts, tol: float = 2e-2) -> float:
    """The kernel's bf16 forward against the plain version in float32 on
    the same (bf16-rounded) q, k, v: the largest error within ``tol`` of
    the plain output's largest magnitude. Returns the largest abs error."""
    qkv = [x.to(torch.bfloat16) for x in qkv]
    err, rel = _rel_errors(kernel(*qkv, *consts), plain(*(x.float() for x in qkv), *consts))
    log(f'{what}: out rel err {rel:.2e} (tolerance {tol:g})')
    check(rel <= tol, f'{what}: {rel:.3e} beyond {tol}')
    return err


def _timing_line(what: str, t: dict, bound_: dict) -> str:
    dev = t['device']
    return (f'  {what}: kernel {t["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms, SDPA '
            f'{t["library"]:.4f} ms; device busy {dev["kernel"]:.4f} / {dev["plain"]:.4f} / '
            f'{dev["library"]:.4f} ms; bound {bound_["bound_ms"]:.4f} ms ({bound_["bound_by"]})')


WINDOW_SIZE, WINDOW_HEAD_DIM = 12, 32  # Swin-L: T 144, D 32
WINDOW_STAGES = {  # Swin-L at 800², training batch 2: (images, padded map side, heads)
    'stage1_b2': (TRAIN_BATCH, 204, 6), 'stage3_b2': (TRAIN_BATCH, 60, 24)}
SERVING_WINDOW_STAGES = {  # the same at the serving batch
    'stage1_b4': (SERVING_BATCH, 204, 6), 'stage3_b4': (SERVING_BATCH, 60, 24)}


def window_inputs(dev: torch.device, images: int, hp: int, heads: int) -> tuple:
    """Swin-L window-attention inputs in float32 for ``images`` padded maps
    of side ``hp``: q, k, v (NW, H, 144, 32), the bias (H, 144, 144) and the
    shift mask (nW_img, 144, 144)."""
    nw, t = images * (hp // WINDOW_SIZE) ** 2, WINDOW_SIZE ** 2
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((nw, heads, t, WINDOW_HEAD_DIM), generator=g, device=dev)
               for _ in range(3))
    bias = torch.randn((heads, t, t), generator=g, device=dev)
    mask = torch.from_numpy(
        shifted_window_attn_mask(hp, hp, WINDOW_SIZE, WINDOW_SIZE // 2)).to(dev)
    return q, k, v, bias, mask


def _window_bounds(q: torch.Tensor, mask: torch.Tensor) -> dict:
    """The forward's and the backward's bound for bf16 q/k/v of q's shape,
    with the shift mask."""
    return {phase: roofline_bound(roofline.window_attention(
        *q.shape, 'bfloat16', True, mask.shape[0], backward=phase == 'bwd'), 'bfloat16')
            for phase in ('fwd', 'bwd')}


def _window_backward_repeats(q, k, v, bias, mask, dtype) -> bool:
    """Whether two backward calls on the same inputs give the same bits of
    dQ, dK, dV and dBias."""
    ins = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)] + \
        [bias.detach().requires_grad_(True)]
    out = window_attention(*ins, mask)
    cot = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(5),
                      device=out.device).to(dtype)
    first, second = (torch.autograd.grad(out, ins, cot, retain_graph=True) for _ in range(2))
    return all(torch.equal(a, b) for a, b in zip(first, second))


def phase_window_attention(dev: torch.device) -> dict:
    """Swin-L at training batch 2, window 12 (T 144, D 32): stage 1
    (2 x 17 x 17 windows, 6 heads) and stage 3 (2 x 5 x 5 windows, 24
    heads); then the bf16 forward alone at the serving batch 4."""
    levels = {'fwd': {}, 'bwd': {}}
    for stage, (images, hp, heads) in WINDOW_STAGES.items():
        q, k, v, bias, mask = window_inputs(dev, images, hp, heads)
        log(f'window attention vs plain at {stage}: NW={q.shape[0]}, H={heads}, '
            f'T={q.shape[2]}, D={q.shape[3]}:')
        errs = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            for m in (None, mask):
                errs[dtype, m is not None] = _check_against_plain(
                    'shifted' if m is not None else 'unshifted', window_attention,
                    window_attention_plain, (q, k, v), (bias,), True, (m,), dtype, tol)
            check(_window_backward_repeats(q, k, v, bias, mask, dtype),
                  f'{stage} {dtype}: two backward calls gave different bits')
        log('  backward bitwise repeatable (dQ, dK, dV, dBias), f32 and bf16')

        # timed at the training path's type, with the shift mask
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        full_mask = (bias[None] + mask.repeat(images, 1, 1)[:, None]).to(torch.bfloat16)
        t_ms = _time_fwd_bwd(window_attention, window_attention_plain, _sdpa(None),
                             [qb, kb, vb, bias], (mask,), (full_mask,))
        bounds = _window_bounds(q, mask)
        for i, phase in enumerate(('fwd', 'bwd')):
            log(_timing_line(f'{phase} bf16 shifted {stage}', t_ms[phase], bounds[phase]))
            levels[phase][stage] = _summary(t_ms[phase], bounds[phase],
                                            errs[torch.bfloat16, True][i])
    levels['fwd'].update(_window_forward_serving(dev))
    # the summary line reports stage 1 at batch 2, and every stage under by_stage
    return {f'window_attention_{phase}': {**by_stage['stage1_b2'], 'by_stage': by_stage}
            for phase, by_stage in levels.items()}


def _window_forward_serving(dev: torch.device) -> dict:
    """The bf16 forward alone, shifted, at the serving batch 4: stage 1
    (NW 1156, H 6) and stage 3 (NW 100, H 24)."""
    result = {}
    for stage, (images, hp, heads) in SERVING_WINDOW_STAGES.items():
        q, k, v, bias, mask = window_inputs(dev, images, hp, heads)
        err = _forward_err(f'window attention forward at {stage}: NW={q.shape[0]}, H={heads}, '
                           'bf16 shifted', window_attention, window_attention_plain, (q, k, v),
                           (bias, mask))
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        full_mask = (bias[None] + mask.repeat(images, 1, 1)[:, None]).to(torch.bfloat16)
        fns = {'plain': lambda: window_attention_plain(qb, kb, vb, bias, mask),
               'kernel': lambda: window_attention(qb, kb, vb, bias, mask),
               'library': lambda: _sdpa(None)(qb, kb, vb, full_mask)}
        t = {**timed_in_turns(fns), 'device': {name: device_ms(fn) for name, fn in fns.items()}}
        bound_ = _window_bounds(q, mask)['fwd']
        log(_timing_line(f'fwd bf16 shifted {stage}', t, bound_))
        result[stage] = _summary(t, bound_, err)
        del q, k, v, qb, kb, vb, full_mask, fns
    return result


def masked_inputs(dev: torch.device, b: int, s: int, heads: int = 8, nq: int = 200,
                  d: int = 32) -> tuple:
    """Decoder cross-attention inputs in float32, seeded by ``s``: q scaled
    by D^-0.5, k, v, and a mask with 70 % of the scores blocked and no row
    fully blocked."""
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((b, heads, nq, d), generator=g, device=dev) * d ** -0.5
    k, v = (torch.randn((b, heads, s, d), generator=g, device=dev) for _ in range(2))
    mask = torch.rand((b, 1, nq, s), generator=g, device=dev) < 0.7
    mask &= ~mask.all(dim=-1, keepdim=True)
    return q, k, v, mask


def phase_masked_attention(dev: torch.device) -> dict:
    """Decoder cross-attention at B 2, H 8, Q 200, D 32 for the three levels."""
    b, heads, nq, d = TRAIN_BATCH, 8, 200, 32
    levels = {'fwd': {}, 'bwd': {}}
    for s in (10000, 2500, 625):
        q, k, v, mask = masked_inputs(dev, b, s, heads, nq, d)
        log(f'masked attention vs plain at B={b}, H={heads}, Q={nq}, S={s}, D={d}, '
            f'{mask.float().mean().item():.3f} masked:')
        errs = {dtype: _check_against_plain('masked', masked_attention, masked_attention_plain,
                                            (q, k, v), (), False, (mask,), dtype, tol)
                for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))}
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        bias = torch.zeros(mask.shape, dtype=torch.bfloat16, device=dev).masked_fill_(mask, -1e9)
        t_ms = _time_fwd_bwd(masked_attention, masked_attention_plain, _sdpa(1.0),
                             [qb, kb, vb], (mask,), (bias,))
        for i, phase in enumerate(('fwd', 'bwd')):
            b_ = roofline_bound(roofline.masked_attention(b, heads, nq, s, d, 'bfloat16',
                                                          backward=phase == 'bwd'), 'bfloat16')
            log(_timing_line(f'{phase} bf16 S={s}', t_ms[phase], b_))
            levels[phase][s] = _summary(t_ms[phase], b_, errs[torch.bfloat16][i])
    # the summary line reports the largest level, and every level under by_s
    result = {f'masked_attention_{phase}': {**by_s[10000], 'by_s': by_s}
              for phase, by_s in levels.items()}
    result['masked_attention_fwd']['serving_b4_s10000'] = _masked_forward_serving(dev)
    return result


def _masked_forward_serving(dev: torch.device) -> dict:
    """The bf16 forward alone at the serving batch: B 4, H 8, Q 200, S 10000."""
    b, heads, nq, s, d = SERVING_BATCH, 8, 200, 10000, 32
    q, k, v, mask = masked_inputs(dev, b, s, heads, nq, d)
    err = _forward_err(f'masked attention forward at the serving batch B={b}, S={s}, bf16',
                       masked_attention, masked_attention_plain, (q, k, v), (mask,))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    bias = torch.zeros(mask.shape, dtype=torch.bfloat16, device=dev).masked_fill_(mask, -1e9)
    fns = {'plain': lambda: masked_attention_plain(q, k, v, mask),
           'kernel': lambda: masked_attention(q, k, v, mask),
           'library': lambda: _sdpa(1.0)(q, k, v, bias)}
    t = {**timed_in_turns(fns), 'device': {name: device_ms(fn) for name, fn in fns.items()}}
    bound_ = roofline_bound(roofline.masked_attention(b, heads, nq, s, d, 'bfloat16'), 'bfloat16')
    log(_timing_line(f'fwd bf16 B={b} S={s}', t, bound_))
    return _summary(t, bound_, err)


MSDA_SHAPES = ((25, 25), (50, 50), (100, 100))  # Swin-L's encoder levels at 800²
MSDA_HEADS, MSDA_POINTS, MSDA_HEAD_DIM, MSDA_CALLS = 8, 4, 32, 10


def msda_inputs(dev: torch.device, batch: int = TRAIN_BATCH) -> tuple:
    """The deformable encoder's MSDA inputs at 800² (training batch 2 unless
    stated), in bf16 as autocast and the bf16 serving model form them: value
    (batch, 13125, 8, 32), locations within a few cells of each query's
    reference point, softmaxed weights, and a cotangent of the output's
    shape."""
    l_total = sum(h * w for h, w in MSDA_SHAPES)
    g = torch.Generator(device=dev).manual_seed(21)
    value = torch.randn((batch, l_total, MSDA_HEADS, MSDA_HEAD_DIM), generator=g,
                        device=dev).bfloat16()
    ref = torch.from_numpy(reference_points_constant(MSDA_SHAPES)).to(dev)
    shape = (batch, l_total, MSDA_HEADS, len(MSDA_SHAPES), MSDA_POINTS)
    locations = (ref[None, :, None, None, None, :]
                 + 0.02 * torch.randn((*shape, 2), generator=g, device=dev)).bfloat16()
    weights = torch.softmax(torch.randn((*shape[:3], shape[3] * shape[4]), generator=g,
                                        device=dev), dim=-1).reshape(shape).bfloat16()
    cot = torch.randn((batch, l_total, MSDA_HEADS * MSDA_HEAD_DIM), generator=g,
                      device=dev).bfloat16()
    return value, locations, weights, cot


@torch.no_grad()
def phase_msda_forward(dev: torch.device) -> dict:
    """The MSDA forward kernel at the serving shape (Swin-L 800², batch 4,
    bf16): the plain version's bits, the same bits from two calls, and its
    times against the plain version's and the byte bound."""
    value, locations, weights, _ = msda_inputs(dev, SERVING_BATCH)
    args = (value, MSDA_SHAPES, locations, weights)
    before = counts()['msda_fwd']
    first, second = deformable_attention.msda(*args), deformable_attention.msda(*args)
    check(counts()['msda_fwd'] - before == 2, 'two MSDA calls did not launch the kernel twice')
    want = deformable_attention._msda_fused(*args)
    differ = int((first != want).sum())
    check(differ == 0, f'the MSDA kernel differs from the plain version at {differ} of '
                       f'{want.numel()} outputs')
    check(torch.equal(first, second), 'two MSDA kernel calls gave different bits')
    t = timed_in_turns({'plain': lambda: deformable_attention._msda_fused(*args),
                        'kernel': lambda: deformable_attention.msda(*args)})
    dev_ms = device_ms(lambda: deformable_attention.msda(*args))
    plain_dev_ms = device_ms(lambda: deformable_attention._msda_fused(*args))
    batch, rows, heads, d = value.shape
    dtype, coord_dtype = (str(x.dtype).removeprefix('torch.') for x in (value, locations))
    work = roofline.msda(batch, locations.shape[1], heads, len(MSDA_SHAPES), MSDA_POINTS, d, rows,
                         dtype, coord_dtype)
    moved, bound_, taps = work[0], roofline_bound(work, dtype), weights.numel() * 4
    log(f'MSDA forward kernel at serving b{SERVING_BATCH} {SERVING_HW}² (value '
        f'{tuple(value.shape)} bf16, {taps / 1e6:.2f} M taps of '
        f'{MSDA_HEAD_DIM * value.element_size()} bytes = '
        f'{taps * MSDA_HEAD_DIM * value.element_size() / 1e9:.2f} GB of row reads): the plain '
        f'version\'s bits, the same bits from two calls; kernel {t["kernel"]:.4f} ms, plain '
        f'{t["plain"]:.4f} ms (medians of {TIMED_RUNS}); device busy {dev_ms:.4f} / '
        f'{plain_dev_ms:.4f} ms; moves {moved / 1e6:.1f} MB, bound {bound_["bound_ms"]:.4f} ms '
        f'({bound_["bound_by"]}), {100 * bound_["bound_ms"] / dev_ms:.2f} % of it')
    return {'max_abs_err': 0.0, 'ms': t['kernel'], 'plain_ms': t['plain'], **bound_,
            'library_ms': None, 'device_ms': dev_ms, 'plain_device_ms': plain_dev_ms,
            'library_device_ms': None}


def phase_msda_value_grad(dev: torch.device) -> dict:
    """The MSDA value gradient at the training shape: the port's
    fixed-order float32 sums (``ops/deformable_attention.py::
    value_grad_sums``) the same bits over ``MSDA_CALLS`` calls and through
    two backward calls, and their device ms per call."""
    value, locations, weights, cot = msda_inputs(dev)
    args = (cot, value.shape, value.dtype, MSDA_SHAPES, locations, weights)
    sums = [deformable_attention.value_grad_sums(*args) for _ in range(MSDA_CALLS)]
    differ = max(int((t != sums[0]).sum()) for t in sums[1:])
    check(differ == 0, f'{differ} MSDA value-gradient sums differ between calls')
    grads = []
    for _ in range(2):
        v = value.detach().requires_grad_(True)
        deformable_attention.msda(v, MSDA_SHAPES, locations, weights).backward(cot)
        grads.append(v.grad)
    check(torch.equal(*grads), 'two MSDA backward calls gave different value-gradient bits')
    ms = device_ms(lambda: deformable_attention.value_grad_sums(*args))
    log(f'MSDA value gradient at training b{TRAIN_BATCH} {TRAIN_HW}² (value {tuple(value.shape)} '
        f'bf16, {sums[0].numel()} float32 sums, 12 tap sets): {differ} sums differ over '
        f'{MSDA_CALLS} calls, the same bits through two backward calls; {ms:.4f} device ms a call')
    return {'sums_differing': differ, 'device_ms': ms}


def check_result(res: dict, batch: int, hw: tuple, num_queries: int) -> None:
    check(set(res) == {'segmentation', 'segment_ids', 'labels', 'scores', 'valid'},
          f'result keys {sorted(res)}')
    check(res['segmentation'].shape == (batch, *hw)
          and res['segmentation'].dtype == torch.int32, 'segmentation shape/dtype')
    for key in ('segment_ids', 'labels', 'scores', 'valid'):
        check(res[key].shape == (batch, num_queries), f'{key} shape {tuple(res[key].shape)}')
    check(bool(torch.isfinite(res['scores']).all()), 'scores not finite')
    seg = res['segmentation']
    check(int(seg.min()) >= -1 and int(seg.max()) < num_queries, 'id map outside [-1, Q)')


def phase_serving(dev: torch.device) -> dict:
    """Swin-L 800² b4 bf16: 3 requests through the serving function, after
    a first that captures its encoder graph: the capture records the
    encoder's kernels, a profiled replay runs them by name, each request
    replays once and its own launches and its replay's add up to a
    request's, and the first replayed request gives the eager request's
    bits. Returns the kernels' launches on the device."""
    t0 = time.perf_counter()
    model = build_model('swin-large', num_labels=5, dtype=torch.bfloat16, device=dev, seed=0)
    log(f'swin-large built in {time.perf_counter() - t0:.1f} s: '
        f'{sum(p.numel() for p in model.parameters())} parameters, bf16')
    serve = make_serving_fn(model, out_hw=(SERVING_HW, SERVING_HW), micro_batch=SERVING_BATCH,
                            emit_masks=False)
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (SERVING_BATCH, SERVING_IN, SERVING_IN, 3)
    requests = [torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
                for _ in range(REQUESTS + 1)]

    cfg = model.config
    per_request = {'fused_upsample_stats': 1, 'window_attention_fwd': sum(cfg.backbone_config.depths),
                   'masked_attention_fwd': cfg.decoder_layers - 1,
                   'msda_fwd': cfg.encoder_layers}
    encoder = {k: per_request[k] if k in ('window_attention_fwd', 'msda_fwd') else 0
               for k in LAUNCH_COUNTERS}
    held, captures = captured_counts(), trace.counter('serve.graph.captures')
    t0 = time.perf_counter()
    serve(requests[0])
    torch.cuda.synchronize()
    log(f'warm-up request: {1e3 * (time.perf_counter() - t0):.1f} ms (first call: lazy init, '
        f'the encoder graph\'s warm-up, capture and first replay)')
    graph = {k: n - held[k] for k, n in captured_counts().items()}
    check(trace.counter('serve.graph.captures') == captures + 1 and graph == encoder,
          f'the first request captured {graph}, not {encoder}')
    (key, replay), = serve.graphs.items()
    kernels = replayed_kernels(replay, requests[1])
    by_name = {'window_attention_fwd': sum(n for k, n in kernels.items()
                                           if k.startswith('window_attention_fwd')),
               'msda_fwd': kernels['msda_fwd_kernel']}
    for name, n in by_name.items():
        check(n == graph[name], f'a profiled replay ran {name} {n} times, the capture '
                                f'recorded {graph[name]}')
    log(f'encoder graph of {key[0]} {key[1]}: captured {graph}; a profiled replay ran '
        f'{sum(kernels.values())} kernels, {by_name} of the hand-written ones, as captured')
    with torch.inference_mode():
        eager = ServingModule(model, out_hw=(SERVING_HW, SERVING_HW), emit_masks=False)(
            requests[1])

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    replays = trace.counter('serve.graph.replays')
    latencies = []
    for i, raw in enumerate(requests[1:]):
        before, replayed = counts(), trace.counter('serve.graph.replays')
        t0 = time.perf_counter()
        res = serve(raw)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        ran = {k: v - before[k] for k, v in counts().items()}
        check(trace.counter('serve.graph.replays') == replayed + 1,
              f'request {i} replayed the graph {trace.counter("serve.graph.replays") - replayed} '
              f'times, not once')
        for name, n in per_request.items():
            check(ran[name] + graph[name] == n, f'request {i} launched {name} {ran[name]} times '
                                                f'and replayed {graph[name]}, not {n} in all')
        check(ran['window_attention_bwd'] == ran['masked_attention_bwd'] == 0,
              'serving launched a backward kernel')
        check_result(res, SERVING_BATCH, (SERVING_HW, SERVING_HW), cfg.num_queries)
        if i == 0:
            for k in eager:
                check(torch.equal(res[k], eager[k]), f'the replayed request\'s {k} differs '
                                                     f'from the eager request\'s')
        log(f'request {i}: {1e3 * latencies[-1]:.1f} ms, {int(res["valid"].sum())} segments kept')
    # launches on the device: the requests' own and their replays' captured ones
    n_replays = trace.counter('serve.graph.replays') - replays
    launches = {k: n + n_replays * graph[k] for k, n in counts().items()}
    log(f'serving swin-large {SERVING_HW}x{SERVING_HW} b{SERVING_BATCH} bf16: '
        f'{REQUESTS * SERVING_BATCH / sum(latencies):.3f} img/s over {REQUESTS} requests '
        f'({n_replays} replays; the first\'s results the eager request\'s bits), '
        f'median latency {1e3 * statistics.median(latencies):.1f} ms, '
        f'peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {launches} '
        f'({counts()} made by the requests, the rest by their replays)')

    _decoder_masked_checks(serve, requests[1], per_request['masked_attention_fwd'], 'swin-large')
    del model, serve, requests
    torch.cuda.empty_cache()
    return launches


def _decoder_masked_checks(serve, raw: torch.Tensor, layers: int, what: str) -> None:
    """One request through ``serve`` with its decoder's masked-attention
    calls recorded: the kernel against the plain version on the masks the
    decoder really makes, within 2e-2 of the largest output."""
    calls = []

    def recording(q, k, v, mask):
        out = masked_attention(q, k, v, mask)
        calls.append((q, k, v, mask, out))
        return out

    transformer_decoder.masked_attention = recording
    try:
        serve(raw)
    finally:
        transformer_decoder.masked_attention = masked_attention
    check(len(calls) == layers, f'the recorded request made {len(calls)} masked-attention calls')
    log(f'{what} decoder masked attention of one request, kernel vs plain (f32 on the same bf16 '
        f'values):')
    with torch.inference_mode():
        for i, (q, k, v, mask, out) in enumerate(calls):
            _, rel = _rel_errors(out, masked_attention_plain(q.float(), k.float(), v.float(), mask))
            log(f'  layer {i}: q {tuple(q.shape)}, S {k.shape[2]}, '
                f'{mask.float().mean().item():.3f} of the scores blocked, out rel err {rel:.2e}')
            check(rel <= 2e-2, f'{what} decoder layer {i}: masked attention {rel:.3e} beyond 0.02')


class _SynthRaw:
    """bench.py's synthetic training samples: 800² float pixels, 10 instances
    of 64 x 64 squares, 5 labels; 8 geometries cycled over distinct files."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i % 8)
        masks = np.zeros((TRAIN_INSTANCES, TRAIN_HW, TRAIN_HW), np.uint8)
        for j in range(TRAIN_INSTANCES):
            y, x = r.integers(0, TRAIN_HW - 64, size=2)
            masks[j, y:y + 64, x:x + 64] = 1
        return {'pixel_values': r.standard_normal((3, TRAIN_HW, TRAIN_HW)).astype(np.float32),
                'mask_labels': masks,
                'class_labels': r.integers(0, TRAIN_LABELS, size=(TRAIN_INSTANCES,)),
                'target_size': (TRAIN_HW, TRAIN_HW),
                'original_map': np.zeros((TRAIN_HW, TRAIN_HW), np.int32),
                'id_to_semantic': {j + 1: 0 for j in range(TRAIN_INSTANCES)},
                'file_name': f'synth_{i:04d}.png'}


def _snapshot(model) -> list:
    return [p.detach().clone() for p in model.parameters()]


def _unchanged(model, snapshot) -> bool:
    return all(torch.equal(p, s) for p, s in zip(model.parameters(), snapshot))


def trace_split(sl: Slice, range_names: tuple) -> tuple[dict, dict, collections.Counter]:
    """From a parsed profiler trace: the device-busy ms of the work launched
    in each of ``range_names``' ranges (a kernel, copy or fill counts in the
    innermost range whose host interval holds its launch call; ``other`` if
    none does), the host ms spent in each range, and the device ms by kernel
    name."""
    ranges = [(a, b, name) for a, b, name, *_ in sl.ranges if name in range_names]
    device_ms = dict.fromkeys(tuple(range_names) + ('other',), 0.0)
    by_kernel = collections.Counter()
    for _, dur, kernel, ts, _ in sl.device:
        # ranges are sorted by start, so the last that holds the launch is the innermost
        name = next((n for a, b, n in reversed(ranges) if ts is not None and a <= ts <= b),
                    'other')
        device_ms[name] += dur / 1e3
        by_kernel[kernel] += dur / 1e3
    host_ms = {n: sum(b - a for a, b, m in ranges if m == n) / 1e3 for n in range_names}
    return device_ms, host_ms, by_kernel


def phase_training(dev: torch.device, cache_dir: str) -> dict:
    """Swin-L 800² b2 bf16, accumulation 2, remat, from the .npz cache."""
    steps_total = WARMUP_STEPS + TIMED_STEPS + 1
    t0 = time.perf_counter()
    process_and_save(_SynthRaw(TRAIN_BATCH * steps_total), cache_dir)
    log(f'synthetic .npz cache of {TRAIN_BATCH * steps_total} samples written in '
        f'{time.perf_counter() - t0:.1f} s')
    dataset = PreprocessedDataset(cache_dir, keys=TRAIN_SAMPLE_KEYS)
    collate = make_train_collate((TRAIN_HW, TRAIN_HW), TRAIN_INSTANCES, TRAIN_BATCH)
    batches = device_batches(DataLoader(dataset, TRAIN_BATCH, collate, prefetch=2), dev)

    model = build_model('swin-large', num_labels=TRAIN_LABELS, device=dev, seed=0, train=True,
                        remat=True)
    cfg = model.config
    optimizer = make_optimizer(model.parameters(), LEARNING_RATE)
    step = make_train_step(model, cfg, optimizer, ACCUMULATION, torch.bfloat16)
    for i in range(WARMUP_STEPS):
        t0 = time.perf_counter()
        loss = step(next(batches))
        torch.cuda.synchronize()
        log(f'warm-up micro-step {i}: loss {loss.item():.4f}, '
            f'{1e3 * (time.perf_counter() - t0):.1f} ms')

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    times = []
    for i in range(TIMED_STEPS):
        batch = next(batches)
        snapshot = _snapshot(model)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = {k: v - before[k] for k, v in counts().items()}
        update = (WARMUP_STEPS + i + 1) % ACCUMULATION == 0
        check(math.isfinite(loss.item()), f'micro-step {i}: loss {loss.item()}')
        for name in ('window_attention_fwd', 'window_attention_bwd', 'masked_attention_fwd',
                     'masked_attention_bwd'):
            check(launched[name] > 0, f'micro-step {i} did not launch {name}')
        check(launched['msda_fwd'] == 0, f'micro-step {i} launched the no-grad MSDA kernel')
        check(_unchanged(model, snapshot) != update,
              f'micro-step {i}: parameters {"unchanged on an update" if update else "changed between updates"}')
        log(f'micro-step {i}: loss {loss.item():.4f}, {1e3 * times[-1]:.1f} ms, '
            f'{"update" if update else "accumulate"}, launches {launched}')
        del snapshot
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = 1e3 * statistics.median(times)
    log(f'training swin-large {TRAIN_HW}x{TRAIN_HW} b{TRAIN_BATCH} bf16 GA{ACCUMULATION} remat: '
        f'micro-step {ms:.1f} ms median ({", ".join(f"{1e3 * t:.1f}" for t in times)}), '
        f'{TRAIN_BATCH * TIMED_STEPS / sum(times):.3f} img/s, peak memory {peak:.2f} GiB, '
        f'launches {launches}')

    # where the time goes: a profiler trace of two more micro-steps (one
    # update), split by the train step's own ranges
    batch = next(batches)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        step(batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    sl = profiled(prof)
    device_ms, host_ms, by_kernel = trace_split(sl, STEP_RANGES)
    value_grad_ms = trace_split(sl, (deformable_attention.VALUE_GRAD_RANGE,))[0]
    busy = sum(device_ms.values())
    log(f'traced 2 micro-steps (one update): {wall:.1f} ms wall, {busy:.1f} ms device busy, '
        f'idle share {max(0.0, 1 - busy / wall):.3f}; the MSDA value-gradient sums '
        f'{value_grad_ms[deformable_attention.VALUE_GRAD_RANGE]:.2f} device ms')
    log('split by the step\'s ranges, summed over both micro-steps: device busy ms '
        + ', '.join(f'{k} {v:.1f}' for k, v in device_ms.items()) + '; host ms '
        + ', '.join(f'{k} {v:.1f}' for k, v in host_ms.items()))
    log('device ms by kernel, top 15:')
    for key, ms in by_kernel.most_common(15):
        log(f'  {ms:9.2f}  {key[:110]}')
    for op in ('window_attention', 'masked_attention'):
        by_name = collections.Counter()
        for key, ms in by_kernel.items():
            if op in key:
                by_name[kernel_name(key)] += ms
        log(f'{op.replace("_", "-")} kernels, device ms: '
            + ', '.join(f'{name} {ms:.2f}' for name, ms in by_name.most_common()))
    del model, optimizer, step, batches
    torch.cuda.empty_cache()
    return launches


class _SynthEval:
    """Test samples as a user's cache holds them: 800² float pixels from
    1024² originals, whose map holds 10 rectangular instances (ids 1-10, a
    later one may cover an earlier one) of 5 labels."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(100 + i)
        original = np.zeros((EVAL_ORIGINAL, EVAL_ORIGINAL), np.int32)
        for j in range(EVAL_INSTANCES):
            h, w = r.integers(EVAL_ORIGINAL // 32, EVAL_ORIGINAL // 4, size=2)
            y, x = r.integers(0, EVAL_ORIGINAL - h), r.integers(0, EVAL_ORIGINAL - w)
            original[y:y + h, x:x + w] = j + 1
        ys = nearest_indices(EVAL_ORIGINAL, TRAIN_HW)
        small = original[ys][:, ys]
        labels = r.integers(0, TRAIN_LABELS, size=EVAL_INSTANCES)
        return {'pixel_values': r.standard_normal((3, TRAIN_HW, TRAIN_HW)).astype(np.float32),
                'mask_labels': np.stack([small == j + 1 for j in range(EVAL_INSTANCES)]
                                        ).astype(np.uint8),
                'class_labels': labels,
                'target_size': (EVAL_ORIGINAL, EVAL_ORIGINAL),
                'original_map': original,
                'id_to_semantic': {j + 1: int(labels[j]) for j in range(EVAL_INSTANCES)},
                'file_name': f'test_{i:04d}.png'}


@contextlib.contextmanager
def _eval_config(root: str):
    """The config an ``engine.test`` run reads, pointed at ``root``: a bf16
    compute dtype (which the test model must not take), batch 2, a
    crop_weed-style ``Processed/Test`` cache."""
    values = {'MODELS_OUTPUT_DIR': os.path.join(root, 'models') + '/',
              'DATASET_LIST': ['crop_weed'], 'BATCH_SIZE': EVAL_BATCH,
              'COMPUTE_DTYPE': 'bfloat16'}
    saved = {name: getattr(config, name) for name in values}
    saved_dir = crop_weed.PROCESSED_DIR
    for name, value in values.items():
        setattr(config, name, value)
    crop_weed.PROCESSED_DIR = os.path.join(root, 'Processed') + '/'
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(config, name, value)
        crop_weed.PROCESSED_DIR = saved_dir


def _check_metric_dict(result: dict, what: str) -> None:
    keys = {'map', 'map_50', 'map_75', 'map_small', 'map_medium', 'map_large', 'mar_1',
            'mar_10', 'mar_100', 'mar_small', 'mar_medium', 'mar_large', 'classes',
            'map_per_class', 'mar_100_per_class'}
    check(result is not None and set(result) == keys, f'{what}: metric keys {result}')
    for key in keys - {'classes'}:
        v = float(result[key])
        check(math.isfinite(v) and (v == -1.0 or 0.0 <= v <= 1.0), f'{what}: {key} = {v}')
    check(float(result['map']) >= 0.0, f'{what}: map {result["map"]} with ground truth present')


def _eval_run(forward, dataset, threshold: float, dev: torch.device) -> dict:
    return metrics.test_with_metrics(forward, DataLoader(dataset, EVAL_BATCH, collate_fn),
                                     threshold, dev)


def phase_eval(dev: torch.device, root: str) -> dict:
    """Swin-L evaluation through ``engine.test`` (float32 whatever the
    compute dtype, batch 2, threshold 0.5) from a saved model directory and a synthetic Test cache; then
    ``test_with_metrics`` alone at thresholds 0.5 and 0.0, once more at 0.0
    under the profiler for the split by stage (``engine/metrics.py``'s
    ranges), and the post-process kernel against its plain version on one
    image's logits from the forward."""
    t0 = time.perf_counter()
    process_and_save(_SynthEval(EVAL_IMAGES), os.path.join(root, 'Processed', 'Test'))
    model = build_model('swin-large', num_labels=TRAIN_LABELS, device=dev, seed=0)
    run_dir = os.path.join(root, 'models', 'mask2former_fine_tuned', '2026-01-01_00-00-00',
                           'best_model')
    save_pretrained(run_dir, model.state_dict(), model.config)
    cfg = model.config
    del model
    torch.cuda.empty_cache()
    log(f'eval: Test cache of {EVAL_IMAGES} images and a swin-large model directory '
        f'({os.path.getsize(os.path.join(run_dir, "params.npz")) / 2**20:.0f} MiB params.npz) '
        f'written in {time.perf_counter() - t0:.1f} s')

    n_batches = -(-EVAL_IMAGES // EVAL_BATCH)
    expected = {'fused_upsample_stats': EVAL_IMAGES,
                'window_attention_fwd': n_batches * sum(cfg.backbone_config.depths),
                'masked_attention_fwd': n_batches * (cfg.decoder_layers - 1),
                'msda_fwd': n_batches * cfg.encoder_layers,
                'window_attention_bwd': 0, 'masked_attention_bwd': 0}
    what = f'swin-large {TRAIN_HW}x{TRAIN_HW} b{EVAL_BATCH} f32, {EVAL_IMAGES} images'

    def checked(run: str, result: dict) -> dict:
        launched = counts()
        _check_metric_dict(result, run)
        for name, n in expected.items():
            check(launched[name] == n, f'eval {run} launched {name} {launched[name]} times, not {n}')
        return launched

    with _eval_config(root):
        # engine.test as a user runs it: checkpoint, cache, loader, metrics
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        result = engine_test.test_model(EVAL_MODEL_ID, device=dev)
        wall = time.perf_counter() - t0
        launches = checked('engine.test', result)
        log(f'eval engine.test (threshold 0.5) {what}: {EVAL_IMAGES / wall:.3f} img/s over '
            f'{1e3 * wall:.1f} ms with the checkpoint and cache loads, peak memory '
            f'{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {launches}')

        model = engine_test.load_test_model(resolve_model_path(EVAL_MODEL_ID), dev)
        check(all(p.dtype == torch.float32 for p in model.parameters()),
              'the test model is not float32 under COMPUTE_DTYPE bfloat16')
        dataset = PreprocessedDataset(os.path.join(root, 'Processed', 'Test'))
        forward = make_forward_fn(model)
        for threshold in (0.5, 0.0):
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = _eval_run(forward, dataset, threshold, dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = checked(f'test_with_metrics at {threshold}', result)
            log(f'eval test_with_metrics (threshold {threshold}) {what}: '
                f'{EVAL_IMAGES / seconds:.3f} img/s over {1e3 * seconds:.1f} ms, peak memory '
                f'{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {launched}; '
                f'map {float(result["map"]):.4f}, map_50 {float(result["map_50"]):.4f}, '
                f'mar_100 {float(result["mar_100"]):.4f}')

        # where the time goes: one more run at threshold 0.0 under the profiler
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _eval_run(forward, dataset, 0.0, dev)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        device_ms, host_ms, _ = trace_split(profiled(prof), metrics.EVAL_RANGES)
        check(host_ms['IoU product'] > 0 and device_ms['IoU product'] > 0,
              'no IoU product on the device at threshold 0.0')
        host_ms['matching'] = (host_ms.pop('metric update') + host_ms.pop('metric compute')
                               - host_ms['IoU product'])
        busy = sum(device_ms.values())
        log(f'eval test_with_metrics (threshold 0.0) traced: {wall:.1f} ms wall, {busy:.1f} ms '
            f'device busy, idle share {max(0.0, 1 - busy / wall):.3f}; host ms by stage: '
            + ', '.join(f'{k} {v:.1f}' for k, v in host_ms.items()) + '; device busy ms: '
            + ', '.join(f'{k} {v:.1f}' for k, v in device_ms.items()))

    # the forward of one batch alone: event-timed, and its device-busy time
    pixels = torch.from_numpy(collate_fn([dataset[i] for i in range(EVAL_BATCH)])
                              ['pixel_values']).to(dev)
    event_ms = statistics.median(time_ms(lambda: forward(pixels)) for _ in range(5))
    split = device_split(lambda: forward(pixels), runs=3)
    log(f'eval forward of one batch ({tuple(pixels.shape)}, f32): {event_ms:.1f} ms '
        f'(median of 5, CUDA events), device busy {sum(split.values()):.1f} ms; top kernels: '
        + '; '.join(f'{kernel_name(k)[:40]} {ms:.2f} ms' for k, ms in split.most_common(6)))

    # one image's post-process as the eval path runs it: the first image's
    # logits from that forward, (1, Q, 200, 200) float32, at the eval's
    # target size
    out = forward(pixels)
    class_logits = out.class_queries_logits[:1]
    mask_logits = out.masks_queries_logits[:1]
    del model, forward, pixels, out
    torch.cuda.empty_cache()
    logits = mask_logits.float().contiguous()
    first = fused_upsample_stats(logits, SCORE_RESOLUTION)
    n_flips, err = check_postprocess(logits, first)
    second = fused_upsample_stats(logits, SCORE_RESOLUTION)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          'two post-process calls on one image gave different bits')
    split = device_split(lambda: post_process_instance_arrays(
        class_logits, mask_logits, (EVAL_ORIGINAL, EVAL_ORIGINAL), 0.5, with_masks=False))
    kernel_ms = sum(ms for key, ms in split.items() if 'band' in kernel_name(key))
    log(f'post-process of one image ({tuple(logits.shape)} -> {SCORE_RESOLUTION} bins, '
        f'{EVAL_ORIGINAL}² target): kernel vs plain {n_flips} bin flips at zero crossings, '
        f'sig_sum max abs err {err:.3e}, pos_cnt exact after flips, two calls the same bits; '
        f'device busy {sum(split.values()):.4f} ms, of which the kernel {kernel_ms:.4f} ms; '
        'top launches: ' + '; '.join(f'{kernel_name(k)[:40]} {1e3 * ms:.1f} µs'
                                     for k, ms in split.most_common(6)))
    return launches


INFER_IMAGES = 4
INFER_WINDOW_STAGES = {  # Swin-L at 800², batch 1: (images, padded map side, heads)
    'stage1_b1': (1, 204, 6), 'stage3_b1': (1, 60, 24)}


def _check_inference_result(res: dict, hw: tuple, num_labels: int, what: str) -> None:
    """An (H, W) id map whose ids are all in ``segments_info`` (a kept
    segment may be covered entirely by later ones, as in HF), distinct ids
    0, 1, … in order, labels below ``num_labels``, scores in [0, 1]."""
    seg = res['segmentation']
    check(seg.shape == hw and np.isfinite(seg).all(), f'{what}: id map {seg.shape}')
    info = res['segments_info']
    check([s['id'] for s in info] == list(range(len(info))), f'{what}: ids {info}')
    ids = {int(v) for v in np.unique(seg)} - {-1}
    check(ids <= {s['id'] for s in info}, f'{what}: map ids {ids} not in segments_info')
    for s in info:
        check(0 <= s['label_id'] < num_labels and 0.0 <= s['score'] <= 1.0, f'{what}: {s}')


def phase_inference(dev: torch.device, root: str) -> dict:
    """The inspection entry points' compute half on phase_eval's Swin-L
    model directory, loaded by ``load_model`` in bf16 (``COMPUTE_DTYPE``):
    ``engine/inference.py::run_inference_array`` on 1 warm-up and 4 timed
    800² uint8 images (no resize runs, so no PIL), then
    ``engine/show_worst_predictions.py::score_images`` over phase_eval's
    8-image Test cache; each kernel's launches against the loops' count
    (window forward 24, masked forward 9, post-process 1 an image); then the
    tiny-test card-vs-CPU check of ``run_inference_array``."""
    card = card_line()
    with _eval_config(root):
        model_dir = resolve_model_path(EVAL_MODEL_ID)
        # a trained model directory holds its processor; phase_eval's has none
        Mask2FormerImageProcessor(size={'shortest_edge': TRAIN_HW, 'longest_edge': 1333}
                                  ).save_pretrained(model_dir)
        t0 = time.perf_counter()
        model, cfg = load_model(EVAL_MODEL_ID, dev)
        processor = ckpt.load_processor(model_dir)
        load_s = time.perf_counter() - t0
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()),
          'load_model under COMPUTE_DTYPE bfloat16 did not give a bf16 model')
    class_bias = torch.zeros(cfg.num_labels + 1)
    class_bias[0] = 4.0
    _keep_slots(model, class_bias)
    forward = make_forward_fn(model)
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (TRAIN_HW, TRAIN_HW, 3), dtype=np.uint8)
              for _ in range(INFER_IMAGES + 1)]
    dataset = PreprocessedDataset(os.path.join(root, 'Processed', 'Test'))

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    run_inference_array(images[0], forward, processor, dev)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    times, kept = [], []
    for i, image in enumerate(images[1:]):
        t0 = time.perf_counter()
        resized, res = run_inference_array(image, forward, processor, dev)
        times.append(time.perf_counter() - t0)  # the result is on the host: synchronised
        check(resized is image, f'inference image {i} was resized')
        _check_inference_result(res, (TRAIN_HW, TRAIN_HW), cfg.num_labels, f'inference image {i}')
        kept.append(len(res['segments_info']))
        check(kept[-1] >= 1, f'inference image {i} kept no segment')
    infer_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    scored = score_images(forward, dataset, dev)
    score_s = time.perf_counter() - t0
    launches = counts()
    score_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    stage_ms = _inference_stages(images[1], forward, processor, dev)  # after the count
    scores = [c['score'] for c in scored]
    check(len(scores) == EVAL_IMAGES and scores == sorted(scores)
          and all(0.0 <= v <= 1.0 for v in scores), f'worst-prediction scores {scores}')
    images_run = INFER_IMAGES + 1 + EVAL_IMAGES
    expected = {'fused_upsample_stats': images_run,
                'window_attention_fwd': images_run * sum(cfg.backbone_config.depths),
                'masked_attention_fwd': images_run * (cfg.decoder_layers - 1),
                'msda_fwd': images_run * cfg.encoder_layers,
                'window_attention_bwd': 0, 'masked_attention_bwd': 0}
    check(launches == expected, f'inference launches {launches}, the loops imply {expected}')
    pixels = processor(images=images[1], return_tensors='np')['pixel_values']
    parity = _postprocess_card_vs_cpu(forward(torch.from_numpy(pixels).to(dev)),
                                      (TRAIN_HW, TRAIN_HW), 'swin-large image 1')
    kernel_errs = _inference_kernel_checks(dev)
    log(f'inference swin-large {TRAIN_HW}x{TRAIN_HW} bf16 (run_inference_array, batch 1): '
        f'{INFER_IMAGES / sum(times):.3f} img/s over {INFER_IMAGES} images, median '
        f'{1e3 * statistics.median(times):.1f} ms ({", ".join(f"{1e3 * t:.1f}" for t in times)}; '
        f'warm-up {warm_ms:.1f}), segments kept {kept}, peak memory {infer_peak:.2f} GiB; '
        f'model load {load_s:.1f} s; bf16 forward max abs err against the plain version at '
        f'its batch-1 shapes: '
        + ', '.join(f'{k} {v:.3e}' for k, v in kernel_errs.items()) + f'; card {card}')
    log(parity)
    log(f'worst-prediction scoring (score_images, bf16, batch 1, threshold 0.5) over '
        f'{EVAL_IMAGES} cached images: {EVAL_IMAGES / score_s:.3f} img/s over '
        f'{1e3 * score_s:.1f} ms, peak memory {score_peak:.2f} GiB, scores {scores}; '
        f'card {card}')
    log(f'inference path launches {launches} ({images_run} images: as the loops imply)')
    log('inference of one image by stage, host ms (each synchronised; median of 3): '
        + ', '.join(f'{k} {v:.1f}' for k, v in stage_ms.items()))
    del model, forward
    torch.cuda.empty_cache()
    _tiny_inference_parity(dev)
    return launches


def _inference_stages(image: np.ndarray, forward, processor, dev: torch.device) -> dict:
    """One image through ``run_inference_array``'s stages, each timed on
    the host and synchronised (median of 3): the processor, the copy to the
    card, the forward, the post-process with its copies back; and the
    forward's device-busy ms."""
    times = collections.defaultdict(list)
    for _ in range(3):
        t0 = time.perf_counter()
        pixels = processor(images=image, return_tensors='np')['pixel_values']
        t1 = time.perf_counter()
        on_card = torch.from_numpy(pixels).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = forward(on_card)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        metrics.post_process_instance_segmentation(out, target_sizes=[image.shape[:2]])
        t4 = time.perf_counter()
        for name, a, b in (('processor', t0, t1), ('copy in', t1, t2), ('forward', t2, t3),
                           ('post-process', t3, t4)):
            times[name].append(1e3 * (b - a))
    stages = {name: statistics.median(ts) for name, ts in times.items()}
    stages['forward device busy'] = device_ms(lambda: forward(on_card), runs=3)
    return stages


def _tiny_inference_parity(dev: torch.device) -> None:
    """tiny-test f32 (TF32 off): ``run_inference_array`` of one 64 x 96
    image on the card and on the CPU: the same ids and labels, scores within
    1e-4, id maps equal on at least 99.9 % of the pixels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = build_model('tiny-test', num_labels=3, device='cpu', seed=0)
    _keep_slots(cpu_model, torch.tensor([4.0, 0.0, -1.0, 0.0]))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    processor = Mask2FormerImageProcessor(size={'shortest_edge': 64, 'longest_edge': 96})
    image = np.random.default_rng(8).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    launches = trace.counter(postprocess_kernel_ops.LAUNCHES)
    _, want = run_inference_array(image, make_forward_fn(cpu_model), processor, 'cpu')
    _, got = run_inference_array(image, make_forward_fn(gpu_model), processor, dev)
    check(trace.counter(postprocess_kernel_ops.LAUNCHES) == launches + 1, 'tiny-test inference did not launch '
                                                         'the post-process kernel')
    n, score_err, agree = _same_segments(got, want, 1e-4, 'tiny-test f32 inference')
    log(f'tiny-test f32 inference, card vs CPU: {n} segments, ids and labels equal, '
        f'scores max abs err {score_err:.2e}, id maps equal on {agree:.5f} of the pixels')
    # the CPU model's logits at bf16 through the post-process on both
    pixels = torch.from_numpy(processor(images=image, return_tensors='np')['pixel_values'])
    out = make_forward_fn(cpu_model)(pixels)
    log(_postprocess_card_vs_cpu(types.SimpleNamespace(
        class_queries_logits=out.class_queries_logits.bfloat16().to(dev),
        masks_queries_logits=out.masks_queries_logits.bfloat16().to(dev)),
        image.shape[:2], 'tiny-test logits'))


def _keep_slots(model: torch.nn.Module, class_bias: torch.Tensor) -> None:
    """Random weights made to keep slots past the 0.5 threshold well clear
    of it: the class head's bias set to ``class_bias`` (favouring class 0)
    and the masks sharpened (10x mask logits; the decoder's attention masks
    read only their sign)."""
    with torch.no_grad():
        model.class_predictor.bias.copy_(class_bias)
        embedder = model.transformer_module.mask_predictor.mask_embedder_2
        embedder.weight.mul_(10.0)
        embedder.bias.mul_(10.0)


def _same_segments(got: dict, want: dict, score_tol: float, what: str) -> tuple:
    """Two results of one image: at least one segment, the same ids and
    labels, scores within ``score_tol``, id maps equal on at least 99.9 % of
    the pixels. Returns (segments, scores' largest abs error, share of equal
    pixels)."""
    key = [(s['id'], s['label_id']) for s in want['segments_info']]
    check(len(key) >= 1, f'{what}: no segment kept')
    check([(s['id'], s['label_id']) for s in got['segments_info']] == key,
          f'{what}: segments differ: {got["segments_info"][:8]} vs {want["segments_info"][:8]}')
    score_err = max(abs(a['score'] - b['score'])
                    for a, b in zip(got['segments_info'], want['segments_info']))
    check(score_err <= score_tol, f'{what}: scores differ by {score_err}')
    agree = float((got['segmentation'] == want['segmentation']).mean())
    check(agree >= 0.999, f'{what}: id maps agree on {agree:.5f} of the pixels')
    return len(key), score_err, agree


def _postprocess_card_vs_cpu(out, hw: tuple, what: str) -> str:
    """One image's logits on the card post-processed there and, copied, on
    the CPU (the plain version): the class probabilities the same bits, and
    ``_same_segments`` with scores within 2e-5 (the kernel's sigmoid sums
    are held to rtol 1e-5 of the plain ones, and scores are rounded to 6
    decimals). Returns the line to log."""
    cls = out.class_queries_logits
    probs_differ = int((class_probabilities(cls).cpu() != class_probabilities(cls.cpu())).sum())
    check(probs_differ == 0, f'{what}: {probs_differ} class probabilities differ, card vs CPU')
    on_cpu = types.SimpleNamespace(class_queries_logits=cls.cpu(),
                                   masks_queries_logits=out.masks_queries_logits.cpu())
    got = metrics.post_process_instance_segmentation(out, target_sizes=[hw])[0]
    want = metrics.post_process_instance_segmentation(on_cpu, target_sizes=[hw])[0]
    n, score_err, agree = _same_segments(got, want, 2e-5, what)
    return (f'{what}, {str(cls.dtype)[6:]} logits post-processed on the card and the CPU: class '
            f'probabilities the same bits, {n} segments, ids and labels equal, scores max abs '
            f'err {score_err:.2e}, id maps equal on {agree:.5f} of the pixels')


def _inference_kernel_checks(dev: torch.device) -> dict:
    """Both attention kernels' bf16 forwards against their plain versions
    at the inference path's batch-1 shapes, where the masked kernel splits
    the keys otherwise than at batch 2 or 4: masked at S 10000, 2500 and
    625; window shifted at stage 1 (NW 289, H 6) and stage 3 (NW 25, H 24).
    Returns each one's largest abs error."""
    errs = {}
    for s in (10000, 2500, 625):
        q, k, v, mask = masked_inputs(dev, 1, s)
        errs[f'masked S {s}'] = _forward_err(
            f'masked attention forward at B=1, S={s}, bf16', masked_attention,
            masked_attention_plain, (q, k, v), (mask,))
    for stage, (images, hp, heads) in INFER_WINDOW_STAGES.items():
        q, k, v, bias, mask = window_inputs(dev, images, hp, heads)
        errs[f'window {stage}'] = _forward_err(
            f'window attention forward at {stage}: NW={q.shape[0]}, H={heads}, bf16 shifted',
            window_attention, window_attention_plain, (q, k, v), (bias, mask))
    return errs


TRAINER_SPLITS = {'Train': 8, 'Validate': 2, 'Test': 4}
TRAINER_KEYS = ('start_time', 'dataset_list', 'base_model', 'batch_size', 'learning_rate',
                'epochs', 'gradient_accumulation', 'max_input_dim', 'preprocessing_time',
                'data_and_model_loading_time', 'training_history', 'training_time',
                'test_metrics', 'test_time', 'end_time', 'total_time', 'input_duty_cycle')


@contextlib.contextmanager
def _patched(*targets):
    """Set each (object, attribute, value) of ``targets``; restore on exit."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    for obj, name, value in targets:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _trainer_config(root: str, arch: str, epochs: int, resume=None) -> tuple:
    """The config ``engine.train`` reads for a pheno_bench-style cache under
    ``root``: from scratch (a ``MODEL_CHECKPOINT`` that does not exist),
    bf16, batch 2, accumulation 2, remat, lr 5e-5."""
    return ((config, 'MODEL_CHECKPOINT', os.path.join(root, 'no-such-checkpoint')),
            (config, 'MODEL_ARCH', arch), (config, 'COMPUTE_DTYPE', 'bfloat16'),
            (config, 'BATCH_SIZE', TRAIN_BATCH), (config, 'GRADIENT_ACCUMULATION', ACCUMULATION),
            (config, 'REMAT', True), (config, 'EPOCHS', epochs),
            (config, 'LEARNING_RATE', LEARNING_RATE), (config, 'DATASET_LIST', ['pheno_bench']),
            (config, 'MODELS_OUTPUT_DIR', os.path.join(root, 'models') + '/'),
            (config, 'RESUME', resume), (config, 'FORCE_PREPROCESSING', False),
            (pheno_bench, 'PROCESSED_DIR', os.path.join(root, 'Processed') + '/'))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def phase_trainer(dev: torch.device, root: str) -> dict:
    """``engine.train`` as a user runs it (``main()``), Swin-L on the card
    from a pheno_bench-style ``.npz`` cache (Train 8 and Validate 2 at 800²
    with 10 instances each, Test 4 from 1024² originals), 1 epoch: metadata,
    history, checkpoints, test metrics and each kernel's launches against
    the loops' counts; the epoch's img/s, each save's seconds and bytes, the
    test phase's img/s, peak memory. Then at tiny-test a resume (1 epoch,
    and ``RESUME`` on to 2) and a ``WISTPU_PROFILE`` run."""
    t0 = time.perf_counter()
    n_train, n_val = TRAINER_SPLITS['Train'], TRAINER_SPLITS['Validate']
    synth = {'Train': Subset(_SynthRaw(16), range(n_train)),
             'Validate': Subset(_SynthRaw(16), range(n_train, n_train + n_val)),
             'Test': _SynthEval(TRAINER_SPLITS['Test'])}
    for split, dataset in synth.items():
        process_and_save(dataset, os.path.join(root, 'Processed', split))
    log(f'trainer: pheno_bench-style cache {TRAINER_SPLITS} written in '
        f'{time.perf_counter() - t0:.1f} s')

    # timings taken around the trainer's own calls
    spans, saves, tests = [], [], []

    def timed_batches(loader, device):
        t_start, n = time.perf_counter(), 0
        for batch in device_batches(loader, device):
            n += 1
            yield batch
        torch.cuda.synchronize(dev)
        spans.append((loader.shuffle, len(loader.dataset), time.perf_counter() - t_start, n))

    def timed_save(kind, fn):
        def save(directory, *args, **kwargs):
            torch.cuda.synchronize(dev)
            t_start = time.perf_counter()
            fn(directory, *args, **kwargs)
            saves.append((kind, os.path.basename(directory), time.perf_counter() - t_start,
                          _dir_bytes(directory)))
        return save

    def timed_test(forward, loader, *args, **kwargs):
        torch.cuda.synchronize(dev)
        t_start = time.perf_counter()
        result = metrics.test_with_metrics(forward, loader, *args, **kwargs)
        torch.cuda.synchronize(dev)
        tests.append((len(loader.dataset), time.perf_counter() - t_start))
        return result

    with _patched(*_trainer_config(root, 'swin-large', 1),
                  (engine_train, 'device_batches', timed_batches),
                  (engine_train, 'test_with_metrics', timed_test),
                  (ckpt, 'save_pretrained', timed_save('model', ckpt.save_pretrained)),
                  (ckpt, 'save_train_checkpoint',
                   timed_save('train state', ckpt.save_train_checkpoint))):
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        engine_train.main()
        wall = time.perf_counter() - t0
        launches = counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    runs = os.listdir(os.path.join(root, 'models', 'mask2former_fine_tuned'))
    check(len(runs) == 1, f'trainer run directories: {runs}')
    run_dir = os.path.join(root, 'models', 'mask2former_fine_tuned', runs[0])
    with open(os.path.join(run_dir, 'metadata.json')) as f:
        metadata = json.load(f)
    missing = [key for key in TRAINER_KEYS if key not in metadata]
    check(not missing, f'trainer metadata lacks {missing} (an exception inside train()?)')
    history = metadata['training_history']
    check(len(history) == 1 and all(math.isfinite(history[0][k])
                                    for k in ('train_loss', 'val_loss')),
          f'trainer history {history}')
    for sub in ('best_model', 'final_model', 'train_state'):
        check(os.path.isdir(os.path.join(run_dir, sub)), f'trainer wrote no {sub}/')
    best_cfg, best_params = load_pretrained(os.path.join(run_dir, 'best_model'))
    check(best_cfg.num_labels == TRAIN_LABELS and len(best_params) > 0,
          'best_model/ does not read back')
    _check_metric_dict(metadata['test_metrics'], 'trainer test_metrics')

    cfg = config_for_arch('swin-large')
    blocks, masked = sum(cfg.backbone_config.depths), cfg.decoder_layers - 1
    micro_steps = -(-TRAINER_SPLITS['Train'] // TRAIN_BATCH)
    val_batches = -(-TRAINER_SPLITS['Validate'] // TRAIN_BATCH)
    test_batches = -(-TRAINER_SPLITS['Test'] // TRAIN_BATCH)
    expected = {'window_attention_fwd': (2 * micro_steps + val_batches + test_batches) * blocks,
                'window_attention_bwd': micro_steps * blocks,
                'masked_attention_fwd': (micro_steps + val_batches + test_batches) * masked,
                'masked_attention_bwd': micro_steps * masked,
                'msda_fwd': (val_batches + test_batches) * cfg.encoder_layers,
                'fused_upsample_stats': TRAINER_SPLITS['Test']}
    check(launches == expected, f'trainer launches {launches}, the loops imply {expected}')

    (_, n_train, epoch_s, _), = [s for s in spans if s[0]]
    (n_test, test_s), = tests
    log(f'trainer swin-large {TRAIN_HW}x{TRAIN_HW} b{TRAIN_BATCH} bf16 GA{ACCUMULATION} remat, '
        f'1 epoch of {n_train} images: {n_train / epoch_s:.3f} img/s over {1e3 * epoch_s:.1f} ms, '
        f'input duty cycle {metadata["input_duty_cycle"]}; loss {history[0]["train_loss"]:.4f}, '
        f'val loss {history[0]["val_loss"]:.4f}; main() {wall:.1f} s; peak memory {peak:.2f} GiB; '
        f'launches {launches} (as the loops imply)')
    for kind, name, seconds, size in saves:
        log(f'trainer save {name}/ ({kind}): {seconds:.2f} s, {size / 2**20:.0f} MiB, '
            f'{size / 2**20 / seconds:.0f} MiB/s')
    log(f'trainer test phase (f32, {n_test} images, threshold 0.5): {n_test / test_s:.3f} img/s '
        f'over {1e3 * test_s:.1f} ms; map {metadata["test_metrics"]["map"]}; metadata '
        f'timings: preprocessing {metadata["preprocessing_time"]}, loading '
        f'{metadata["data_and_model_loading_time"]}, training {metadata["training_time"]}, '
        f'test {metadata["test_time"]}')

    # resume at tiny-test: 1 epoch, then RESUME on to 2
    tiny = os.path.join(root, 'tiny')
    for split, n in (('Train', 3), ('Validate', 2), ('Test', 2)):
        process_and_save(_tiny_cache_samples(n, split), os.path.join(tiny, 'Processed', split))
    first, second = os.path.join(tiny, 'first'), os.path.join(tiny, 'second')
    with _patched(*_trainer_config(tiny, 'tiny-test', 1)):
        engine_train.train(first, {}, ['pheno_bench'], dev)
    with _patched(*_trainer_config(tiny, 'tiny-test', 2, resume=first)):
        resumed = engine_train.train(second, {}, ['pheno_bench'], dev)
    with open(os.path.join(first, 'train_state', ckpt.TRAIN_META_FILE)) as f:
        step_first = json.load(f)['step']
    with open(os.path.join(second, 'train_state', ckpt.TRAIN_META_FILE)) as f:
        step_second = json.load(f)['step']
    epochs = [h['epoch'] for h in resumed.get('training_history', [])]
    # (the resumed run's own directory holds a best_model/, and so a test
    # phase, only if epoch 2 improved the validation loss, as in JAX)
    check(epochs == [1, 2] and resumed.get('resumed_from') and 'training_time' in resumed,
          f'resumed run: history epochs {epochs}, keys {sorted(resumed)}')
    check(step_second == 2 * step_first == 4, f'micro-steps {step_first} then {step_second}')
    log(f'trainer resume at tiny-test on the card: history epochs {epochs}, micro-steps '
        f'{step_first} after epoch 1 and {step_second} after the resumed epoch 2, losses '
        + ', '.join(f'{h["train_loss"]:.4f}' for h in resumed['training_history']))

    # WISTPU_PROFILE at tiny-test: 3 epochs of 3 micro-steps, 3-8 traced
    profile_dir = os.path.join(tiny, 'profile')
    os.environ['WISTPU_PROFILE'] = profile_dir
    try:
        with _patched(*_trainer_config(tiny, 'tiny-test', 3), (config, 'BATCH_SIZE', 1)):
            profiled = engine_train.train(os.path.join(tiny, 'profiled'), {}, ['pheno_bench'], dev)
    finally:
        del os.environ['WISTPU_PROFILE']
    duty = profiled.get('device_duty_profiled')
    check(duty is not None and 0.0 < duty <= 1.0
          and os.path.exists(os.path.join(profile_dir, 'trace.json')),
          f'WISTPU_PROFILE: device_duty_profiled {duty}')
    log(f'trainer WISTPU_PROFILE at tiny-test: trace of micro-steps 3-8 written, '
        f'device_duty_profiled {duty}, input_duty_cycle {profiled.get("input_duty_cycle")}')
    return launches


DP_RANKS, DP_BATCH = 2, 4  # two processes share the card; the global batch, 2 rows a rank
DP_LOSS_RTOL = 2e-2  # bf16 autocast: the first loss of b2 ranks against one b4 process
DP_TIMEOUT = 600


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _dp_config(root: str, data_parallel: int) -> tuple:
    """phase_trainer's settings, with the global batch of 4 over
    ``data_parallel`` ranks, writing under ``<root>/dp<n>``."""
    return _trainer_config(root, 'swin-large', 1) + (
        (config, 'BATCH_SIZE', DP_BATCH), (config, 'DATA_PARALLEL', data_parallel),
        (config, 'MODELS_OUTPUT_DIR', os.path.join(root, f'dp{data_parallel}', 'models') + '/'))


def _dp_worker(spec: dict) -> None:
    """One rank of ``engine.train.main()`` (``python3 chip_smoke.py
    --data-parallel-rank <json>``): times each micro-step and the epoch,
    records the losses, launches, peak memory and the files this rank
    created, into ``<out>/rank<r>.json``."""
    from weed_instance_segmentation_tpu_torch.engine.steps import TrainStep

    rank = spec['rank']
    os.environ.update({'WISTPU_COORDINATOR': f'localhost:{spec["port"]}',
                       'WISTPU_NUM_PROCESSES': str(DP_RANKS), 'WISTPU_PROCESS_ID': str(rank)})
    report = {'losses': [], 'step_ms': []}
    writes = []

    def audit(event, args):  # the files and directories this rank creates
        if event == 'open' and isinstance(args[0], str) and isinstance(args[1], str) and any(
                m in args[1] for m in 'wax+'):
            writes.append(args[0])
        elif event == 'os.mkdir':
            writes.append(str(args[0]))

    class TimedStep(TrainStep):
        def __call__(self, batch, draws=None):
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            loss = super().__call__(batch, draws)
            report['losses'].append(loss.item())
            report['step_ms'].append(1e3 * (time.perf_counter() - t_start))
            return loss

    def timed_batches(loader, device):
        t_start, n = time.perf_counter(), 0
        for batch in device_batches(loader, device):
            n += 1
            yield batch
        torch.cuda.synchronize()
        if loader.shuffle:
            report['epoch_s'] = time.perf_counter() - t_start
            report['epoch_images'] = len(loader.dataset)

    sys.addaudithook(audit)
    with _patched(*_dp_config(spec['root'], DP_RANKS),
                  (engine_train, 'make_train_step', TimedStep),
                  (engine_train, 'device_batches', timed_batches)):
        reset_counts()
        engine_train.main()
        report['launches'] = counts()
    report['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    run_root = os.path.join(spec['root'], f'dp{DP_RANKS}') + os.sep
    report['writes'] = sorted({w for w in writes if w.startswith(run_root)})
    with open(os.path.join(spec['out'], f'rank{rank}.json'), 'w') as f:
        json.dump(report, f)


def _run_ranks(root: str, out: str) -> list[dict]:
    """``engine.train.main()`` as two processes on the card; their reports.
    Every process started here is stopped before this returns."""
    os.makedirs(out, exist_ok=True)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--data-parallel-rank', json.dumps(
            {'rank': r, 'port': port, 'root': root, 'out': out})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(DP_RANKS)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, text) in enumerate(zip(procs, outputs)):
        check(proc.returncode == 0, f'data-parallel rank {r} exited {proc.returncode}:\n'
              f'{text[-6000:]}')
    reports = []
    for r in range(DP_RANKS):
        with open(os.path.join(out, f'rank{r}.json')) as f:
            reports.append(json.load(f))
    return reports


def _one_process_first_loss(dev: torch.device, root: str) -> tuple:
    """The first micro-step of the trainer's run on one process with the
    whole global batch of 4 (the trainer's labels, seed, loader order and
    draws), then one micro-step with ``augment`` on: (loss, augmented loss,
    the augmented step's launches)."""
    from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import (
        ConcatDataset, compute_static_pad_hw,
    )
    from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model_for_labels
    from weed_instance_segmentation_tpu_torch.processing.augment import AugmentConfig

    with _patched(*_dp_config(root, 1)):
        id2label, label2id = engine_train.get_unified_labels(config.DATASET_LIST)
        dirs = [os.path.join(pheno_bench.PROCESSED_DIR, s) for s in engine_train.SPLITS]
        pad_hw, data_instances = compute_static_pad_hw(dirs)
        collate = make_train_collate(pad_hw, min(max(data_instances, 1), config.MAX_INSTANCES),
                                     DP_BATCH)
        train_set = ConcatDataset([PreprocessedDataset(dirs[0], keys=TRAIN_SAMPLE_KEYS)])
        batch = next(device_batches(DataLoader(train_set, DP_BATCH, collate, shuffle=True), dev))
        losses, launches = [], None
        for augment in (None, AugmentConfig()):
            model, cfg = build_model_for_labels(id2label, label2id, device=dev)
            step = make_train_step(model, cfg, make_optimizer(model.parameters(), LEARNING_RATE),
                                   ACCUMULATION, torch.bfloat16, seed=engine_train.TRAIN_SEED,
                                   augment=augment)
            reset_counts()
            losses.append(step(batch).item())
            launches = counts()
            del model, step
            torch.cuda.empty_cache()
    return losses[0], losses[1], launches


def _augment_card_vs_cpu(dev: torch.device) -> str:
    """``apply_factors`` at the trainer's shape (b2, 800², 10 instances) on
    the card against the CPU on the same factors: pixels within 1e-4 of
    ±2.6, the masks, pixel mask and ``instance_valid`` the same bits."""
    from weed_instance_segmentation_tpu_torch.processing.augment import (
        AugmentConfig, apply_factors, draw_factors,
    )

    collate = make_train_collate((TRAIN_HW, TRAIN_HW), TRAIN_INSTANCES, TRAIN_BATCH)
    batch = to_device(collate([_SynthRaw(2)[i] for i in range(2)]), 'cpu')
    batch['pixel_mask'][1, 700:] = 0.0  # one image with padding, as a wider batch leaves it
    cfg = AugmentConfig(hflip_prob=0.5, scale_prob=1.0)
    factors = draw_factors(TRAIN_BATCH, cfg, torch.Generator().manual_seed(5), 'cpu')
    want = apply_factors(batch, factors, cfg)
    got = apply_factors({k: v.to(dev) for k, v in batch.items()},
                        {k: v.to(dev) for k, v in factors.items()}, cfg)
    err = (got['pixel_values'].cpu() - want['pixel_values']).abs().max().item()
    check(err <= 1e-4, f'augmentation pixels card vs CPU: {err:.3e} beyond 1e-4')
    for key in ('mask_labels', 'pixel_mask', 'instance_valid'):
        differ = int((got[key].cpu() != want[key]).sum())
        check(differ == 0, f'augmentation {key} card vs CPU: {differ} entries differ')
    return (f'scale {[round(v, 4) for v in factors["scale"].tolist()]}, flip '
            f'{factors["flip"].tolist()}: pixels max abs err {err:.3e}, masks, pixel mask and '
            f'instance_valid the same bits')


def phase_data_parallel(dev: torch.device, root: str) -> dict:
    """``engine.train.main()`` as two processes on the one card (``gloo``:
    NCCL refuses two ranks on one device), ``DATA_PARALLEL=2``, Swin-L 800²
    bf16, ``BATCH_SIZE`` 4 (2 a rank), accumulation 2, remat, one epoch over
    phase_trainer's cache (Train 8, Validate 2, Test 4): the averaged first
    loss against one process on the same global batch (rtol
    ``DP_LOSS_RTOL``), each rank's launches against the loops' count (the
    sharded test phase's post-process included), the metadata and metric
    dict, and every file of the run written by rank 0 alone; each rank's
    micro-step ms, the epoch's img/s and the peak memory. Then a micro-step
    with ``WISTPU_AUGMENT``'s recipe, and the augmentation on the card
    against the CPU. Two ranks on one card measure correctness, not
    scaling. ``MODEL_PARALLEL=2`` is not run here: FSDP2 over ``gloo`` on
    CUDA tensors crashed both ranks (PERF.md §7), so the model-sharded path
    is held on the CPU until a machine has two cards."""
    torch.cuda.empty_cache()
    want, augmented, aug_launches = _one_process_first_loss(dev, root)
    cfg = config_for_arch('swin-large')
    blocks, masked = sum(cfg.backbone_config.depths), cfg.decoder_layers - 1
    micro_steps = TRAINER_SPLITS['Train'] // DP_BATCH
    val_batches = test_batches = 1
    expected = {'window_attention_fwd': (2 * micro_steps + val_batches + test_batches) * blocks,
                'window_attention_bwd': micro_steps * blocks,
                'masked_attention_fwd': (micro_steps + val_batches + test_batches) * masked,
                'masked_attention_bwd': micro_steps * masked,
                'msda_fwd': (val_batches + test_batches) * cfg.encoder_layers,
                'fused_upsample_stats': TRAINER_SPLITS['Test'] // DP_RANKS}
    t0 = time.perf_counter()
    reports = _run_ranks(root, os.path.join(root, 'dp_reports'))
    log(f'data parallel: two engine.train.main() processes in {time.perf_counter() - t0:.1f} s')
    run_root = os.path.join(root, f'dp{DP_RANKS}', 'models', 'mask2former_fine_tuned')
    (run_dir,) = [os.path.join(run_root, d) for d in os.listdir(run_root)]
    with open(os.path.join(run_dir, 'metadata.json')) as f:
        metadata = json.load(f)
    missing = [key for key in TRAINER_KEYS if key not in metadata]
    check(not missing, f'data-parallel metadata lacks {missing}')
    _check_metric_dict(metadata['test_metrics'], 'data-parallel test_metrics')
    for r, report in enumerate(reports):
        log(f'data parallel rank {r}: micro-step {statistics.median(report["step_ms"]):.1f} ms '
            f'median ({", ".join(f"{t:.1f}" for t in report["step_ms"])}), epoch '
            f'{report["epoch_images"] / report["epoch_s"]:.3f} img/s over '
            f'{1e3 * report["epoch_s"]:.1f} ms, peak memory {report["peak_gib"]:.2f} GiB, '
            f'launches {report["launches"]}')
        check(report['launches'] == expected,
              f'rank {r} launches {report["launches"]}, the loops imply {expected}')
        check(len(report['losses']) == micro_steps
              and all(math.isfinite(x) for x in report['losses']),
              f'rank {r} losses {report["losses"]}')
    check(reports[0]['losses'] == reports[1]['losses'],
          'the ranks report different averaged losses')
    written = reports[0]['writes']
    for path in ('best_model/params.npz', 'train_state/opt_state.npz', 'metadata.json'):
        check(os.path.join(run_dir, path) in written, f'rank 0 did not write {path}')
    check(reports[1]['writes'] == [], f'rank 1 wrote {reports[1]["writes"][:5]}')
    rel = abs(reports[0]['losses'][0] - want) / abs(want)
    log(f'data parallel: losses {reports[0]["losses"]}, the first against one process on the '
        f'global batch {want:.6f}: rel {rel:.3e} (rtol {DP_LOSS_RTOL}); map '
        f'{metadata["test_metrics"]["map"]}; rank 0 alone wrote the run\'s {len(written)} '
        f'files and directories')
    check(rel <= DP_LOSS_RTOL, f'first loss {reports[0]["losses"][0]:.6f} against one process '
          f'{want:.6f}: {rel:.3e} beyond {DP_LOSS_RTOL}')
    check(math.isfinite(augmented) and aug_launches['window_attention_bwd'] > 0
          and aug_launches['masked_attention_bwd'] > 0,
          f'augmented micro-step: loss {augmented}, launches {aug_launches}')
    log(f'augmented micro-step (WISTPU_AUGMENT recipe, b{DP_BATCH}): loss {augmented:.4f} '
        f'against {want:.4f} without, launches {aug_launches}')
    log(f'augmentation card vs CPU at b{TRAIN_BATCH} {TRAIN_HW}²: {_augment_card_vs_cpu(dev)}')
    return reports[0]['launches']


def _tiny_cache_samples(n: int, split: str) -> list:
    """Tiny 64 x 96 samples (2 rectangles of labels 1 and 2) as a
    pheno_bench cache holds them."""
    samples = []
    for i in range(n):
        r = np.random.default_rng(300 + i + 10 * len(split))
        original = np.zeros((64, 96), np.int32)
        original[8:30, 10:40], original[35:60, 50:90] = 1, 2
        samples.append({'pixel_values': r.standard_normal((3, 64, 96)).astype(np.float32),
                        'mask_labels': np.stack([original == 1, original == 2]).astype(np.uint8),
                        'class_labels': np.asarray([1, 2]), 'target_size': (64, 96),
                        'original_map': original, 'id_to_semantic': {1: 1, 2: 2},
                        'file_name': f'{split}_{i:03d}.png'})
    return samples


def _tiny_eval_samples(model, n: int) -> list:
    """Cache samples whose ground truth is the tiny model's own kept
    segments at threshold 0 (every other one moved by 3 pixels, every third
    given another label), so the metric lies away from 0 and 1."""
    samples = []
    for i in range(n):
        rng = np.random.default_rng(200 + i)
        pixels = rng.standard_normal((3, 64, 96)).astype(np.float32)
        target = (128, 192)
        with torch.no_grad():
            out = model(torch.from_numpy(pixels[None]))
        pred = metrics.post_process_instance_segmentation(out, threshold=0.0,
                                                          target_sizes=[target])[0]
        seg = pred['segmentation'].astype(np.int32)
        original = np.where(seg >= 0, seg + 1, 0).astype(np.int32)
        mapping = {}
        for j, info in enumerate(pred['segments_info']):
            uid = info['id'] + 1
            if j % 2:
                moved = np.roll(original == uid, 3, axis=1)
                original[original == uid] = 0
                original[moved & (original == 0)] = uid
            mapping[uid] = info['label_id'] if j % 3 else (info['label_id'] + 1) % 3
        samples.append({'pixel_values': pixels, 'mask_labels': np.zeros((0, 64, 96), np.uint8),
                        'class_labels': np.zeros(0, np.int64), 'target_size': target,
                        'original_map': original, 'id_to_semantic': mapping,
                        'file_name': f'tiny_{i:03d}.png'})
    return samples


def phase_tiny_eval(dev: torch.device, root: str) -> None:
    """tiny-test f32: ``test_with_metrics`` at threshold 0.0 on the card and
    on the CPU over one cache; then ``mask_iou_matrix`` on 100 x 1024²
    against 20 x 1024² masks on both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = build_model('tiny-test', num_labels=3, device='cpu', seed=0)
    with torch.no_grad():  # favour class 0, so that the slots' scores spread
        cpu_model.class_predictor.bias.copy_(torch.tensor([2.0, 0.0, -1.0, 0.0]))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    cache = os.path.join(root, 'tiny_test_cache')
    process_and_save(_tiny_eval_samples(cpu_model, 5), cache)
    results, maps = [], []
    post_process = metrics.post_process_instance_segmentation
    for model, device in ((cpu_model, torch.device('cpu')), (gpu_model, dev)):
        seen = []

        def recording(*args, **kwargs):
            out = post_process(*args, **kwargs)
            seen.extend(p['segmentation'] for p in out)
            return out

        metrics.post_process_instance_segmentation = recording
        try:
            results.append(metrics.test_with_metrics(
                make_forward_fn(model), DataLoader(PreprocessedDataset(cache), 2, collate_fn),
                0.0, device))
        finally:
            metrics.post_process_instance_segmentation = post_process
        maps.append(seen)
    want, got = results
    flips = sum(int((a != b).sum()) for a, b in zip(*maps))
    diffs = {k: float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)
                              ).max()) for k in want}
    check(got.keys() == want.keys() and float(want['map']) > 0.0, f'tiny eval keys/map {want}')
    if flips == 0:
        check(all(v == 0.0 for v in diffs.values()), f'tiny eval card vs CPU differ: {diffs}')
    else:
        check(all(v <= 0.01 for v in diffs.values()), f'tiny eval beyond 0.01: {diffs}')
    log(f'tiny-test f32 eval at threshold 0.0, card vs CPU: map {float(got["map"]):.6f} vs '
        f'{float(want["map"]):.6f}, {flips} id-map pixels differ (bin flips at zero '
        f'crossings), largest metric difference {max(diffs.values()):.3e}')

    g = torch.Generator(device=dev).manual_seed(11)
    preds = torch.rand((100, EVAL_ORIGINAL, EVAL_ORIGINAL), generator=g, device=dev) < 0.3
    gts = torch.rand((20, EVAL_ORIGINAL, EVAL_ORIGINAL), generator=g, device=dev) < 0.5
    preds_np, gts_np = preds.cpu().numpy(), gts.cpu().numpy()
    del preds, gts
    t0 = time.perf_counter()
    on_card = mean_ap.mask_iou_matrix(preds_np, gts_np, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = mean_ap.mask_iou_matrix(preds_np, gts_np, device='cpu')
    cpu_s = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(on_card, on_cpu)),
          'mask_iou_matrix: the card and the CPU give different bits')
    a = preds_np.reshape(100, -1).astype(np.float32)
    b = gts_np.reshape(20, -1).astype(np.float32)
    dev_a, dev_b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    product_ms = timed_in_turns({'product': lambda: dev_a @ dev_b.T}, runs=10)['product']
    product_work = ((a.size + b.size) * 4 + 100 * 20 * 4, 2 * 100 * 20 * a.shape[1])
    product_bound = roofline_bound(product_work, 'float32')
    log(f'mask_iou_matrix 100 x 1024² against 20 x 1024²: the same bits on the card and the '
        f'CPU; {1e3 * card_s:.1f} ms on the card with the host copies, {1e3 * cpu_s:.1f} ms on '
        f'the CPU; the f32 product alone {product_ms:.4f} ms on the card (bound '
        f'{product_bound["bound_ms"]:.4f} ms, {product_bound["bound_by"]})')


def _tiny_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    samples = []
    for n in (3, 2):
        masks = np.zeros((n, 64, 96), np.uint8)
        for j in range(n):
            y, x = rng.integers(0, 48), rng.integers(0, 80)
            masks[j, y:y + 12, x:x + 14] = 1
        samples.append({'pixel_values': rng.standard_normal((3, 64, 96)).astype(np.float32),
                        'mask_labels': masks, 'class_labels': rng.integers(0, 3, n)})
    return make_train_collate((64, 96), 4, 2)(samples)


def phase_tiny_parity(dev: torch.device) -> None:
    """tiny-test f32: the card's serving output and one train step against
    the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = build_model('tiny-test', num_labels=3, device='cpu', seed=0)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    out_hw, threshold = (64, 96), 0.23  # 2x upscale: the pre-process is exact
    raw = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8))
    launches = trace.counter(postprocess_kernel_ops.LAUNCHES)
    want = make_serving_fn(cpu_model, out_hw=out_hw, threshold=threshold)(raw)
    got = {k: v.cpu() for k, v in
           make_serving_fn(gpu_model, out_hw=out_hw, threshold=threshold)(raw.to(dev)).items()}
    check(trace.counter(postprocess_kernel_ops.LAUNCHES) == launches + 1, 'tiny-test did not launch the kernel')
    check(int(want['valid'].sum()) >= 1, 'no segment kept at tiny-test')
    for key in ('valid', 'segment_ids', 'labels'):
        check(torch.equal(got[key], want[key]), f'tiny-test {key} differs')
    score_err = (got['scores'] - want['scores']).abs().max().item()
    check(score_err <= 1e-4, f'tiny-test scores differ by {score_err}')

    # the id map may differ only where a mask logit crosses zero within the
    # logit difference between the two devices
    with torch.inference_mode():
        px, _ = fused_preprocess(raw, out_hw, out_hw)
        logits_cpu = cpu_model(px).masks_queries_logits
        logits_gpu = gpu_model(px.to(dev)).masks_queries_logits.cpu()
    margin = (logits_gpu - logits_cpu).abs().max().item() + 1e-5
    near_zero = (upsample_plain(logits_cpu, SCORE_RESOLUTION).abs() <= margin).any(dim=1)
    ys = torch.from_numpy(nearest_indices(SCORE_RESOLUTION[0], out_hw[0]))
    xs = torch.from_numpy(nearest_indices(SCORE_RESOLUTION[1], out_hw[1]))
    near_zero = near_zero[:, ys][:, :, xs]  # at target size
    differ = got['segmentation'] != want['segmentation']
    check(bool(near_zero[differ].all()), 'id map differs away from zero crossings')
    masks_differ = got['masks'] != want['masks']
    check(bool(near_zero[:, None].expand_as(masks_differ)[masks_differ].all()),
          'masks differ away from zero crossings')
    log(f'tiny-test f32 serving, card vs CPU: {int(want["valid"].sum())} segments kept, '
        f'valid/ids/labels equal, scores max abs err {score_err:.2e}, id map differs at '
        f'{int(differ.sum())} pixels (all at zero crossings within {margin:.2e}), logits max '
        f'abs diff {margin - 1e-5:.2e}')

    # one train step: the kernels forward and backward on the card, the plain
    # path on the CPU, the same random draws (a CPU generator on both sides)
    cpu_model = build_model('tiny-test', num_labels=3, device='cpu', seed=0, train=True)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    batch = _tiny_batch(0)
    results = []
    for model, device in ((cpu_model, torch.device('cpu')), (gpu_model, dev)):
        step = make_train_step(model, model.config,
                               make_optimizer(model.parameters(), LEARNING_RATE))
        before = counts()
        loss = step(to_device(batch, device), PointDraws(torch.Generator().manual_seed(3)))
        launched = {k: v - before[k] for k, v in counts().items()}
        results.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                        {n: p.detach().cpu() for n, p in model.named_parameters()}, launched))
    (want_loss, want_grads, want_params, cpu_launched), (loss, grads, params, gpu_launched) = results
    check(not any(cpu_launched.values()), f'the CPU step launched kernels: {cpu_launched}')
    check(all(gpu_launched[k] > 0 for k in gpu_launched
              if k not in ('fused_upsample_stats', 'msda_fwd')) and gpu_launched['msda_fwd'] == 0,
          f'the card step did not launch every attention kernel, or launched the no-grad '
          f'MSDA kernel: {gpu_launched}')
    loss_err = abs(loss - want_loss) / abs(want_loss)
    check(loss_err <= 1e-5, f'tiny-test train loss differs by {loss_err:.2e} relative')
    worst, noise_leaves = (0.0, ''), []
    for name, want in want_grads.items():
        err = (grads[name] - want).abs().max().item()
        scale = want.abs().max().item()
        if scale < 1e-6:  # zero in exact arithmetic: float32 noise, held to 1e-6 absolute
            noise_leaves.append(name)
            check(err <= 1e-6, f'gradient of noise leaf {name}: {err:.3e}')
        else:
            check(err <= 1e-4 * scale, f'gradient of {name}: {err:.3e} of {scale:.3e}')
            worst = max(worst, (err / scale, name))
    noisy, worst_param = 0, (0.0, '')
    for name, want in want_params.items():
        # entries whose gradient is noise get an Adam update of up to ±lr
        noise = torch.maximum(grads[name].abs(), want_grads[name].abs()) < 1e-6
        err = (params[name] - want).abs()
        check(bool((err <= torch.where(noise, 2 * LEARNING_RATE * (1 + 1e-3), 1e-6)).all()),
              f'updated {name} differs by {err.max().item():.3e}')
        noisy += int(noise.sum())
        worst_param = max(worst_param, (err[~noise].max().item() if (~noise).any() else 0.0, name))
    log(f'tiny-test f32 train step, card vs CPU: loss {loss:.6f} vs {want_loss:.6f} '
        f'({loss_err:.2e} relative); worst gradient leaf {worst[1]} at {worst[0]:.2e} of its '
        f'largest; leaves below the 1e-6 noise level, held to 1e-6 absolute: {noise_leaves}; '
        f'worst updated parameter {worst_param[1]} at {worst_param[0]:.2e} '
        f'({noisy} entries with noise gradients held to 2 lr); launches {gpu_launched}')


EXPORT_REQUESTS = 5
EXPORT_ARCHS = {  # arch → launches a request: window, masked and MSDA forward, post-process
    'swin-large': {'window_attention_fwd': 24, 'masked_attention_fwd': 9, 'msda_fwd': 6,
                   'fused_upsample_stats': 1},
    'resnet50': {'window_attention_fwd': 0, 'masked_attention_fwd': 9, 'msda_fwd': 6,
                 'fused_upsample_stats': 1},
}
EXPORT_SCORE_TOL = 1e-5  # loaded program against the live function, the same kernels
# the artifact loaded where the port's model code cannot be imported: it
# serves the export phase's requests, counts each one's launches and saves
# the results for the parent to hold against the live serving function
_LOAD_ALONE = r"""
import json, sys, time
sys.modules['weed_instance_segmentation_tpu_torch.models'] = None  # import raises
import torch
from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.engine.export import load_serving
from weed_instance_segmentation_tpu_torch.ops import deformable_attention, masked_attention
from weed_instance_segmentation_tpu_torch.ops import postprocess_kernel, window_attention
out_dir, n, shape, results = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3]), sys.argv[4]
t0 = time.perf_counter()
serve, manifest = load_serving(out_dir)
load_s = time.perf_counter() - t0
dev = torch.device('cuda', 0)
g = torch.Generator(device=dev).manual_seed(0)
requests = [torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
            for _ in range(n)]
ops = {'window_attention_fwd': window_attention.LAUNCHES,
       'masked_attention_fwd': masked_attention.LAUNCHES,
       'msda_fwd': deformable_attention.LAUNCHES,
       'fused_upsample_stats': postprocess_kernel.LAUNCHES}
launches, out = [], []
for raw in requests:
    before = {k: trace.counter(name) for k, name in ops.items()}
    res = serve(raw)
    torch.cuda.synchronize()
    launches.append({k: trace.counter(name) - before[k] for k, name in ops.items()})
    out.append({k: v.cpu() for k, v in res.items()})
torch.save(out, results)
blocked = sys.modules.get('weed_instance_segmentation_tpu_torch.models', 0) is None
print(json.dumps({'load_s': load_s, 'launches': launches, 'platforms': manifest['platforms'],
                  'models_blocked': blocked}))
"""


def _export_requests(dev: torch.device) -> list:
    """The export phase's uint8 requests, from a seed (``_LOAD_ALONE`` makes
    the same ones)."""
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (SERVING_BATCH, SERVING_IN, SERVING_IN, 3)
    return [torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
            for _ in range(EXPORT_REQUESTS)]


def _same_result(got: dict, want: dict, what: str) -> float:
    """Segmentation, segment ids, labels and valid flags equal; scores within
    ``EXPORT_SCORE_TOL``. Returns the scores' largest abs difference."""
    check(set(got) == set(want), f'{what}: keys {sorted(got)} vs {sorted(want)}')
    for key in ('segmentation', 'segment_ids', 'labels', 'valid'):
        check(torch.equal(got[key].cpu(), want[key].cpu()), f'{what}: {key} differs')
    err = (got['scores'].cpu() - want['scores'].cpu()).abs().max().item()
    check(err <= EXPORT_SCORE_TOL, f'{what}: scores differ by {err:.3e}')
    return err


def _op_dispatch_us(dev: torch.device, calls: int = 400) -> dict:
    """Host µs a call of each attention wrapper (checks, the registered
    operator's dispatch, its CUDA implementation's launch) and of that CUDA
    implementation called directly, at the inference path's smallest
    shapes (bf16: masked B 1, S 625; window stage 3 at batch 1), in blocks
    of ``calls`` taken in turns, each block ending in a synchronise."""
    q, k, v, mask = (t.to(torch.bfloat16) if t.is_floating_point() else t
                     for t in masked_inputs(dev, 1, 625))
    wq, wk, wv, bias, wmask = window_inputs(dev, *INFER_WINDOW_STAGES['stage3_b1'])
    wq, wk, wv = (t.to(torch.bfloat16) for t in (wq, wk, wv))
    fns = {'masked wrapper': lambda: masked_attention(q, k, v, mask),
           'masked direct': lambda: masked_attention_ops._forward_cuda(q, k, v, mask),
           'window wrapper': lambda: window_attention(wq, wk, wv, bias, wmask),
           'window direct': lambda: window_attention_ops._forward_cuda(wq, wk, wv, bias, wmask)}
    times = {name: [] for name in fns}
    with torch.no_grad():
        for r in range(4):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fns[name]()
                torch.cuda.synchronize()
                times[name].append(1e6 * (time.perf_counter() - t0) / calls)
    return {name: min(ts) for name, ts in times.items()}


def phase_export(dev: torch.device, root: str) -> dict:
    """The serving export entry point at full width, for both architectures
    the JAX export CLI builds: Swin-L (200 queries) and Mask2Former-R50 (100
    queries), 1024² uint8 → 800², batch 4, bf16, random seeded weights with
    class 0's bias raised and the masks sharpened so that slots pass 0.5.
    Each: ``export_serving`` (seconds, artifact MiB); ``load_serving`` in a
    fresh ``python3`` that cannot import the port's ``models``, serving
    ``EXPORT_REQUESTS`` requests with each request's launches exactly those
    of ``EXPORT_ARCHS``; the same requests through the program loaded here
    and through the live ``make_serving_fn`` (one capture, every request
    replayed): the same segmentation, ids,
    labels and valid flags, scores within ``EXPORT_SCORE_TOL``; the loaded
    program's launches over the requests (counts set to 0 just before);
    then the median ms per request, img/s and peak memory of both, timed
    in turns. Returns each arch's launches."""
    card = card_line()
    shape = [SERVING_BATCH, SERVING_IN, SERVING_IN, 3]
    hw = (SERVING_HW, SERVING_HW)
    launches_by_arch = {}
    for arch, per_request in EXPORT_ARCHS.items():
        model = build_model(arch, num_labels=5, dtype=torch.bfloat16, device=dev, seed=0)
        cfg = model.config
        class_bias = torch.zeros(cfg.num_labels + 1)
        class_bias[0] = 4.0
        _keep_slots(model, class_bias)
        out_dir = os.path.join(root, arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        artifact = export_serving(model, out_dir, batch=SERVING_BATCH, in_hw=(SERVING_IN,) * 2,
                                  out_hw=hw, emit_masks=False,
                                  manifest_extra={'arch': arch, 'compute_dtype': 'bfloat16'})
        export_s = time.perf_counter() - t0
        mib = os.path.getsize(artifact) / 2**20

        results = os.path.join(root, f'{arch}_alone.pt')
        env = {**os.environ, 'PYTHONPATH': os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p])}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, '-c', _LOAD_ALONE, out_dir, str(EXPORT_REQUESTS),
                               json.dumps(shape), results], env=env, capture_output=True,
                              text=True, timeout=600)
        alone_s = time.perf_counter() - t0
        check(proc.returncode == 0, f'{arch}: load_serving alone failed:\n{proc.stderr[-3000:]}')
        alone = json.loads(proc.stdout.strip().splitlines()[-1])
        check(alone['models_blocked'] and alone['platforms'] == ['cuda'],
              f'{arch}: the load-alone process {alone}')
        for i, launched in enumerate(alone['launches']):
            check(launched == per_request, f'{arch}: loaded alone, request {i} launched '
                                           f'{launched}, not {per_request}')
        alone_out = torch.load(results)

        live = make_serving_fn(model, out_hw=hw, emit_masks=False)
        t0 = time.perf_counter()
        loaded, manifest = load_serving(out_dir)
        load_s = time.perf_counter() - t0
        requests = _export_requests(dev)
        captures, replays = (trace.counter(f'serve.graph.{n}') for n in ('captures', 'replays'))
        want = [live(raw) for raw in requests]
        check(trace.counter('serve.graph.captures') == captures + 1
              and trace.counter('serve.graph.replays') == replays + EXPORT_REQUESTS,
              f'{arch}: the live function did not capture once and replay every request')
        reset_counts()
        got = [loaded(raw) for raw in requests]
        torch.cuda.synchronize()
        launches = counts()
        expected = {**{k: n * EXPORT_REQUESTS for k, n in per_request.items()},
                    'window_attention_bwd': 0, 'masked_attention_bwd': 0}
        check(launches == expected, f'{arch}: loaded program launches {launches}, not {expected}')
        errs = []
        for i, (g_, a, w) in enumerate(zip(got, alone_out, want)):
            check_result(g_, SERVING_BATCH, hw, cfg.num_queries)
            errs.append(_same_result(g_, w, f'{arch} request {i}, loaded here vs live'))
            errs.append(_same_result(a, w, f'{arch} request {i}, loaded alone vs live'))
        kept = [int(w['valid'].sum()) for w in want]
        check(sum(kept) >= 1, f'{arch}: no segment kept in {EXPORT_REQUESTS} requests')
        if arch == 'resnet50':  # shapes no other phase checks: Q 100
            _decoder_masked_checks(live, requests[0], per_request['masked_attention_fwd'], arch)
            with torch.inference_mode():
                pixels, _ = fused_preprocess(requests[0], hw, hw)
                logits = model(pixels).masks_queries_logits.float()
            n_flips, err = check_postprocess(logits, fused_upsample_stats(logits,
                                                                          SCORE_RESOLUTION))
            log(f'{arch} post-process kernel vs plain on one request\'s logits '
                f'{tuple(logits.shape)}: {n_flips} bin flips at zero crossings, sig_sum max '
                f'abs err {err:.3e}, pos_cnt exact after flips')

        fns = {'loaded': loaded, 'live': live}
        peaks = {}
        for name, fn in fns.items():  # warm, and each one's peak alone
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            fn(requests[0])
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated(dev) / 2**30
        times = {name: [] for name in fns}
        for r, raw in enumerate(requests):
            for name in (('loaded', 'live') if r % 2 == 0 else ('live', 'loaded')):
                t0 = time.perf_counter()
                fns[name](raw)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
        log(f'export {arch} {SERVING_HW}x{SERVING_HW} b{SERVING_BATCH} bf16 (from '
            f'{SERVING_IN}² uint8, {cfg.num_queries} queries): export_serving {export_s:.1f} s, '
            f'artifact {mib:.1f} MiB; load_serving here {load_s:.1f} s; alone (a python3 that '
            f'cannot import the port\'s models) {alone["load_s"]:.1f} s to load, '
            f'{alone_s:.1f} s for the process; launches a request {per_request}, here over '
            f'{EXPORT_REQUESTS} requests {launches}; outputs equal to the live function\'s '
            f'(segmentation, ids, labels, valid; its encoder graph replayed every request), scores max abs diff {max(errs):.3e}; '
            f'segments kept {kept}; card {card}')
        for name, ts in times.items():
            log(f'  {name}: median {1e3 * statistics.median(ts):.1f} ms a request '
                f'({", ".join(f"{1e3 * t:.1f}" for t in ts)}), '
                f'{EXPORT_REQUESTS * SERVING_BATCH / sum(ts):.3f} img/s, '
                f'peak memory {peaks[name]:.2f} GiB')
        launches_by_arch[arch] = launches
        del model, live, loaded, got, want, alone_out
        torch.cuda.empty_cache()
    dispatch = _op_dispatch_us(dev)
    log('host µs a call, wrapper through the registered operator against its CUDA '
        'implementation called directly (best of 4 blocks of 400): '
        + ', '.join(f'{name} {us:.1f}' for name, us in dispatch.items()))
    return launches_by_arch


def main() -> int:
    if sys.argv[1:2] == ['--data-parallel-rank']:
        _dp_worker(json.loads(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        log('chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU')
        return 1
    t_start = time.perf_counter()
    dev = torch.device('cuda', 0)
    card = card_line()
    log(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'python {sys.version.split()[0]}')

    t0 = time.perf_counter()
    build_libraries(LIBRARIES)
    log(f'built {len(build_log)} of {len(LIBRARIES)} libraries in '
        f'{time.perf_counter() - t0:.2f} s (nvcc in parallel)')
    for name in LIBRARIES:
        seconds, output = build_log.get(name, (0.0, 'already built'))
        log(f'{name}: {seconds:.2f} s')
        log('\n'.join(line for line in output.splitlines() if any(
            w in line for w in ('entry function', 'registers', 'spill', 'error'))))

    timing = {'fused_upsample_stats': phase_postprocess_kernel(dev)}
    timing.update(phase_window_attention(dev))
    timing.update(phase_masked_attention(dev))
    timing['msda_fwd'] = phase_msda_forward(dev)
    phase_msda_value_grad(dev)

    serving = phase_serving(dev)
    with tempfile.TemporaryDirectory() as cache_dir:
        training = phase_training(dev, cache_dir)
    with tempfile.TemporaryDirectory() as root:
        evaluation = phase_eval(dev, root)
        inference = phase_inference(dev, root)
    with tempfile.TemporaryDirectory() as root:
        exported = phase_export(dev, root)
    for name in ('window_attention_fwd', 'window_attention_bwd', 'masked_attention_fwd',
                 'masked_attention_bwd'):
        check(training[name] > 0, f'the training run never launched {name}')
    check(serving['fused_upsample_stats'] > 0, 'the serving run never launched the post-process')
    check(training['msda_fwd'] == 0, 'the training run launched the no-grad MSDA kernel')
    for name in ('fused_upsample_stats', 'window_attention_fwd', 'masked_attention_fwd',
                 'msda_fwd'):
        check(evaluation[name] > 0, f'the eval run never launched {name}')
        check(inference[name] > 0, f'the inference run never launched {name}')
        check(exported['swin-large'][name] > 0, f'the export run never launched {name}')
    check(exported['resnet50']['masked_attention_fwd'] > 0
          and exported['resnet50']['msda_fwd'] > 0
          and exported['resnet50']['fused_upsample_stats'] > 0,
          'the resnet export run never launched the masked attention, MSDA or the post-process')
    phase_tiny_parity(dev)
    with tempfile.TemporaryDirectory() as root:
        phase_tiny_eval(dev, root)
    with tempfile.TemporaryDirectory() as root:
        trainer = phase_trainer(dev, root)
        data_parallel = phase_data_parallel(dev, root)
    for name in KERNELS:
        check(trainer[name] > 0, f'the trainer run never launched {name}')
        check(data_parallel[name] > 0, f'the data-parallel run never launched {name}')

    path = {'fused_upsample_stats': serving, 'msda_fwd': serving}
    kernels = []
    for name, replaces in KERNELS.items():
        launches = path.get(name, training)[name]
        kernels.append({'name': name, 'route': 'cuda',
                        'source': f'weed_instance_segmentation_tpu_torch/csrc/'
                                  f'{KERNEL_LIBRARY[name]}.cu',
                        'replaces': replaces,
                        'launches': launches,
                        'launches_by_path': {'serving': serving[name], 'training': training[name],
                                             'eval': evaluation[name],
                                             'inference': inference[name],
                                             'trainer': trainer[name],
                                             'data_parallel': data_parallel[name],
                                             'export': exported['swin-large'][name],
                                             'resnet': exported['resnet50'][name]},
                        **timing[name]})
    log(f'chip_smoke.py: every phase passed in {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
