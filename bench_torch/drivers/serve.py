"""Batch serving, one closed-loop client.

Each request is a batch of seeded uint8 images from pinned host memory
(a pool of distinct batches, cycled), copied to the card, served by the
program's ``make_serving_fn`` and its result arrays copied back to the host.
The window ends with the first request that completes after ``--seconds``;
``serve_img_per_s`` is every image returned over the window's length, and
``serve_p95_ms`` the 95th percentile of every request's time from its send
to its result on the host.

After the window the requests the reference checks are drawn from the
seed, served again with the decoder's attention masks recorded (their
answers must be the window's, bit for bit), and the program is freed before
the reference runs.

Traffic keys: ``batch``, ``image_hw``, ``model_hw``, ``threshold``,
``emit_masks``, ``pool`` (distinct batches), ``warmup_requests``,
``trace_requests``, ``check_requests`` (requests the reference recomputes).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_torch import compare, spans, tracing
from bench_torch.reference import model as ref_model
from bench_torch.reference.postprocess import answers
from bench_torch.weights import derive_seed

RESULT_KEYS = ('segmentation', 'segment_ids', 'labels', 'scores', 'valid')


def make_pool(run, t: dict) -> list:
    """``pool`` batches of uint8 (B, H, W, 3) in pinned host memory."""
    g = torch.Generator(device=run.device).manual_seed(derive_seed(run.seed, 'images'))
    shape = (t['batch'], *t['image_hw'], 3)
    pool = []
    for _ in range(t['pool']):
        images = torch.randint(0, 256, shape, generator=g, device=run.device, dtype=torch.uint8)
        pool.append(images.cpu().pin_memory() if run.cuda else images)
    return pool


def well_formed(res: dict, t: dict, queries: int) -> bool:
    b, (h, w) = t['batch'], t['model_hw']
    return (res['segmentation'].shape == (b, h, w) and res['scores'].shape == (b, queries)
            and bool(torch.isfinite(res['scores']).all())
            and int(res['segmentation'].min()) >= -1
            and int(res['segmentation'].max()) < queries)


def run(run) -> None:
    from weed_instance_segmentation_tpu_torch.engine import export
    from weed_instance_segmentation_tpu_torch.models import transformer_decoder

    t, cfg = run.traffic, run.config
    dev = run.device
    model = run.program_model(run.compute_dtype())
    serve = export.make_serving_fn(model, out_hw=tuple(t['model_hw']), threshold=t['threshold'],
                                   micro_batch=t['batch'], emit_masks=t['emit_masks'])
    pool = make_pool(run, t)

    def request(i: int) -> dict:
        res = serve(pool[i % len(pool)].to(dev, non_blocking=True))
        return {k: res[k].to('cpu') for k in RESULT_KEYS}

    for i in range(t['warmup_requests']):
        request(i)
    run.set_up_done()

    latencies, results = [], []
    start = time.perf_counter()
    while True:
        sent = time.perf_counter()
        results.append(request(len(results)))
        done = time.perf_counter()
        latencies.append(done - sent)
        if done - start >= run.seconds:
            break
    elapsed = done - start
    images = len(results) * t['batch']
    run.window.update({'serve_img_per_s': images / elapsed,
                       'serve_p95_ms': 1e3 * float(np.percentile(latencies, 95)),
                       'requests': len(results), 'images': images, 'elapsed_s': elapsed})
    run.attempted = len(results)
    run.failed = sum(not well_formed(r, t, cfg['num_queries']) for r in results)
    run.read_peak()

    if run.trace:
        calls = []
        k = t['trace_requests']
        layers = {'bench.backbone': model.backbone, 'bench.pixel_decoder': model.pixel_decoder,
                  'bench.decoder': model.transformer_module}
        with spans.module_ranges(layers), spans.msda_ranges(calls), spans.function_range(
                export, 'post_process_instance_arrays', 'bench.postprocess'):
            run.slice = tracing.capture(lambda: [request(i) for i in range(k)], k, run.synchronize)
        run.slice.msda_calls = calls

    # the compared requests, drawn from the seed among the window's, each
    # from a distinct pool batch, served again with their decoder's
    # attention masks recorded: the reference follows those decisions
    order = np.random.default_rng(derive_seed(run.seed, 'sample')).permutation(len(results))
    picked, seen = [], set()
    for i in order:
        if i % len(pool) not in seen:
            seen.add(i % len(pool))
            picked.append(int(i))
        if len(picked) == t['check_requests']:
            break
    masks, replay_diff = [], 0
    for i in picked:
        calls = []
        with spans.recording(transformer_decoder, 'masked_attention', calls,
                             lambda args, out: args[3].cpu()):
            again = request(i)
        masks.append(calls)
        replay_diff += sum(int((again[k] != results[i][k]).sum()) for k in RESULT_KEYS)

    del serve, model
    if run.cuda:
        torch.cuda.empty_cache()
    gaps = check_requests(run, [pool[i % len(pool)] for i in picked],
                          [results[i] for i in picked], masks)
    gaps['replay_diff'] = float(replay_diff)
    compare.hold(run, gaps)
    run.notes['kept_slots_per_image'] = float(sum(
        int(results[i]['valid'].sum()) for i in picked)) / (len(picked) * t['batch'])


def check_requests(run, inputs: list, results: list, masks: list) -> dict:
    """The float32 reference's answers to ``inputs``, each following the
    decoder attention masks ``masks`` gave it, against ``results``:
    ``compare.ServeGaps`` over them; ``mask_flip_share``, the share of the
    followed mask decisions that differ from the reference's own,
    ``mask_far_share`` the share that differ by more than ``compare.FAR``
    of the reference's margin on them, their ``mask_tally`` by margin, and
    ``mask_gap`` (``reference.model.TransformerModule.forward``)."""
    t = run.traffic
    reference = run.reference_model(run.device)
    reference.load_state_dict({k: v.float() for k, v in run.state_dict(
        run.compute_dtype()).items()})
    reference.eval()
    gaps = compare.ServeGaps(t['threshold'], run.config['num_labels'])
    mask_gap, flips, decisions = 0.0, 0, 0
    counts = [0] * (len(ref_model.MARGINS) + 1)
    with torch.no_grad(), ref_model.float32_products():
        for raw, res, forced in zip(inputs, results, masks):
            pixels = ref_model.preprocess(raw.to(run.device), tuple(t['model_hw']))
            probe = {'forced': forced}
            class_logits, mask_logits = reference(pixels, probe=probe)
            mask_gap = max(mask_gap, probe['mask_gap'])
            flips += probe['mask_flips']
            decisions += probe['mask_decisions']
            counts = [a + c for a, c in zip(counts, probe['mask_tally'])]
            ref = answers(class_logits[-1], mask_logits[-1], tuple(t['model_hw']),
                          t['threshold'])
            gaps.add({k: v.to(run.device) for k, v in res.items()}, ref)
    del reference
    return {**gaps.numbers(), 'mask_flip_share': compare.share(flips, decisions, mask_gap),
            'mask_far_share': compare.far_share(counts, decisions, mask_gap, compare.FAR),
            'mask_tally': counts, 'mask_gap': mask_gap}
