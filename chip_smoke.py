"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero on any failure):

1. the card: name and power limit;
2. build the CUDA kernels from ``weed_instance_segmentation_tpu_torch/csrc``
   (into the package's ``build/`` directory, on first use);
3. the post-process kernel against its plain PyTorch version at the serving
   shape, (4, 200, 200, 200) f32 logits → 384², with both times;
4. the serving slice: Swin-L Mask2Former, 800², batch 4, bf16, random seeded
   weights; 3 requests of uint8 (4, 1024, 1024, 3) through
   ``make_serving_fn``; every request must launch the kernel;
5. the same serving function at tiny-test in float32 on the card against the
   same model on the CPU (the plain path).

The last lines are a JSON summary of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.engine.export import make_serving_fn
from weed_instance_segmentation_tpu_torch.engine.model_utils import build_model
from weed_instance_segmentation_tpu_torch.ops.cuda_build import build_log, load_library
from weed_instance_segmentation_tpu_torch.ops.postprocess_kernel import (
    fused_upsample_stats, fused_upsample_stats_plain, upsample_plain,
)
from weed_instance_segmentation_tpu_torch.ops.resize import nearest_indices
from weed_instance_segmentation_tpu_torch.processing.fused import fused_preprocess
from weed_instance_segmentation_tpu_torch.processing.postprocess import SCORE_RESOLUTION

KERNEL_SOURCE = 'weed_instance_segmentation_tpu_torch/csrc/postprocess_stats.cu'
KERNEL_REPLACES = 'weed_instance_segmentation_tpu/ops/postprocess_kernel.py:88'
SERVING_BATCH, SERVING_IN, SERVING_HW, REQUESTS = 4, 1024, 800, 3
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


def phase_kernel(dev: torch.device) -> dict:
    """Kernel vs plain version at the serving shape."""
    b, q, hm, wm = SERVING_BATCH, 200, SERVING_HW // 4, SERVING_HW // 4
    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn((b, q, hm, wm), generator=g, device=dev) * 2
    sig, cnt, bins = fused_upsample_stats(logits, SCORE_RESOLUTION)
    p_sig, p_cnt, p_bins = fused_upsample_stats_plain(logits, SCORE_RESOLUTION)
    up = upsample_plain(logits, SCORE_RESOLUTION)
    torch.cuda.synchronize()

    # a bin may flip only at a zero crossing: |up| within float32 summation noise
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
    log(f'kernel vs plain at {tuple(logits.shape)} -> {SCORE_RESOLUTION}: '
        f'{n_flips} bin flips at zero crossings, sig_sum max abs err {err.max().item():.3e} '
        f'(max rel {(err / p_sig_adj.abs()).max().item():.3e}), pos_cnt exact after flips')
    del up, p_bins, bins, delta

    kernel_ms, plain_ms = [], []
    for _ in range(3):  # warm up both
        fused_upsample_stats(logits, SCORE_RESOLUTION)
        fused_upsample_stats_plain(logits, SCORE_RESOLUTION)
    for _ in range(TIMED_RUNS):  # in turns: plain, kernel
        plain_ms.append(time_ms(lambda: fused_upsample_stats_plain(logits, SCORE_RESOLUTION)))
        kernel_ms.append(time_ms(lambda: fused_upsample_stats(logits, SCORE_RESOLUTION)))
    k, p = statistics.median(kernel_ms), statistics.median(plain_ms)
    moved = logits.numel() * 4 + b * q * SCORE_RESOLUTION[0] * SCORE_RESOLUTION[1]
    log(f'kernel {k:.4f} ms, plain {p:.4f} ms (medians of {TIMED_RUNS} runs each, CUDA events); '
        f'kernel moves {moved / 1e6:.1f} MB = {moved / k / 1e6:.1f} GB/s')
    return {'max_abs_err': err.max().item(), 'ms': k, 'plain_ms': p}


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


def phase_serving(dev: torch.device) -> int:
    """Swin-L 800² b4 bf16: 3 requests through the serving function."""
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

    t0 = time.perf_counter()
    serve(requests[0])
    torch.cuda.synchronize()
    log(f'warm-up request: {1e3 * (time.perf_counter() - t0):.1f} ms (first call, lazy init)')

    torch.cuda.reset_peak_memory_stats(dev)
    fused_upsample_stats.launches = 0
    latencies = []
    for i, raw in enumerate(requests[1:]):
        before = fused_upsample_stats.launches
        t0 = time.perf_counter()
        res = serve(raw)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        check(fused_upsample_stats.launches > before, f'request {i} did not launch the kernel')
        check_result(res, SERVING_BATCH, (SERVING_HW, SERVING_HW), model.config.num_queries)
        log(f'request {i}: {1e3 * latencies[-1]:.1f} ms, '
            f'{int(res["valid"].sum())} segments kept')
    launches = fused_upsample_stats.launches
    log(f'serving swin-large {SERVING_HW}x{SERVING_HW} b{SERVING_BATCH} bf16: '
        f'{REQUESTS * SERVING_BATCH / sum(latencies):.3f} img/s over {REQUESTS} requests, '
        f'median latency {1e3 * statistics.median(latencies):.1f} ms, '
        f'peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, '
        f'kernel launches {launches}')
    return launches


def phase_tiny_parity(dev: torch.device) -> None:
    """tiny-test f32: the card's serving output against the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = build_model('tiny-test', num_labels=3, seed=0)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    out_hw, threshold = (64, 96), 0.23  # 2x upscale: the pre-process is exact
    raw = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8))
    launches = fused_upsample_stats.launches
    want = make_serving_fn(cpu_model, out_hw=out_hw, threshold=threshold)(raw)
    got = {k: v.cpu() for k, v in
           make_serving_fn(gpu_model, out_hw=out_hw, threshold=threshold)(raw.to(dev)).items()}
    check(fused_upsample_stats.launches == launches + 1, 'tiny-test did not launch the kernel')
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
    log(f'tiny-test f32 card vs CPU: {int(want["valid"].sum())} segments kept, valid/ids/labels '
        f'equal, scores max abs err {score_err:.2e}, id map differs at {int(differ.sum())} '
        f'pixels (all at zero crossings within {margin:.2e}), logits max abs diff '
        f'{margin - 1e-5:.2e}')


def main() -> int:
    if not torch.cuda.is_available():
        log('chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU')
        return 1
    dev = torch.device('cuda', 0)
    card = card_line()
    log(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'python {sys.version.split()[0]}')

    t0 = time.perf_counter()
    load_library('postprocess_stats')
    seconds, compiler_output = build_log.get('postprocess_stats', (0.0, 'already built'))
    log(f'built postprocess_stats in {seconds:.2f} s (load {time.perf_counter() - t0:.2f} s)')
    log(compiler_output.strip())

    timing = phase_kernel(dev)
    launches = phase_serving(dev)
    check(launches > 0, 'the serving path never launched the kernel')
    phase_tiny_parity(dev)

    print(json.dumps({'kernels': [{
        'name': 'fused_upsample_stats', 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': KERNEL_REPLACES, 'launches': launches, **timing,
    }]}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
