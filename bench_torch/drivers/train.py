"""Fine-tuning: the program's train step fed from a synthetic ``.npz`` cache.

Set-up writes ``cache_samples`` seeded samples (``image_hw`` float pixels,
``instances`` square instances of ``instance_hw`` of ``num_labels``
labels) with the program's ``process_and_save``, reads them back through
``PreprocessedDataset``, the training collate, ``DataLoader`` (``prefetch``)
and ``device_batches``, cycled, and builds one train step (model with the
benchmark's seeded weights, AdamW at ``learning_rate``, ``accumulation``
micro-steps an update, ``remat``, the configuration's compute dtype under
autocast). Each micro-step's random draws come from a generator the
benchmark seeds from (seed, micro-step). Set-up drives the step through
its first ``warmup_micro_steps`` micro-steps and keeps what the reference
checks of the first ``check_micro_steps`` (two updates): their losses, the
first update's gradient of each parameter (from AdamW's first moment), each
parameter's change after the check's micro-steps, and the decisions the
reference follows (the matcher's assignments, the sampled points, the
decoder's attention masks).

The window runs whole updates; ``train_img_per_s`` counts their images
over the time from the window's start to the last update's synchronise.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import tempfile
import time

import numpy as np
import torch

from bench_torch import compare, spans, tracing
from bench_torch.reference import criterion as ref_criterion
from bench_torch.reference import model as ref_model
from bench_torch.weights import derive_seed


class SynthTrain:
    """Seeded training samples in the layout ``process_and_save`` writes."""

    def __init__(self, seed: int, n: int, t: dict, labels: int):
        self.seed, self.n, self.t, self.labels = seed, n, t, labels

    def __len__(self):
        return self.n

    def arrays(self, i: int) -> tuple:
        h, w = self.t['image_hw']
        ih, iw = self.t['instance_hw']
        r = np.random.default_rng(derive_seed(self.seed, 'sample', i))
        pixels = r.standard_normal((3, h, w), dtype=np.float32)
        masks = np.zeros((self.t['instances'], h, w), np.uint8)
        for j in range(self.t['instances']):
            y, x = r.integers(0, h - ih), r.integers(0, w - iw)
            masks[j, y:y + ih, x:x + iw] = 1
        return pixels, masks, r.integers(0, self.labels, size=self.t['instances'])

    def __getitem__(self, i):
        pixels, masks, labels = self.arrays(i)
        h, w = self.t['image_hw']
        return {'pixel_values': pixels, 'mask_labels': masks, 'class_labels': labels,
                'target_size': (h, w), 'original_map': np.zeros((h, w), np.int32),
                'id_to_semantic': {j + 1: int(c) for j, c in enumerate(labels)},
                'file_name': f'sample_{i:05d}.png'}


def draws(run, index: int):
    from weed_instance_segmentation_tpu_torch.losses.criterion import PointDraws

    g = torch.Generator(device=run.device).manual_seed(derive_seed(run.seed, 'draws', index))
    return PointDraws(g)


def leaf_norms(named: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in named.items()}


def run(run) -> None:
    from weed_instance_segmentation_tpu_torch.datasets.dataset_utils import (
        TRAIN_SAMPLE_KEYS, PreprocessedDataset, make_train_collate, process_and_save,
    )
    from weed_instance_segmentation_tpu_torch.datasets.loader import DataLoader, device_batches
    from weed_instance_segmentation_tpu_torch.engine.steps import make_optimizer, make_train_step
    from weed_instance_segmentation_tpu_torch.losses import criterion
    from weed_instance_segmentation_tpu_torch.models import transformer_decoder

    t, cfg = run.traffic, run.config
    batch, accum = t['batch'], t['accumulation']
    samples = SynthTrain(run.seed, t['cache_samples'], t, cfg['num_labels'])
    cache = tempfile.TemporaryDirectory(prefix='bench_train_cache_')
    process_and_save(samples, cache.name)
    dataset = PreprocessedDataset(cache.name, keys=TRAIN_SAMPLE_KEYS)
    collate = make_train_collate(tuple(t['image_hw']), t['instances'], batch)
    loader = DataLoader(dataset, batch, collate, prefetch=t['prefetch'])
    feed = device_batches(itertools.chain.from_iterable(itertools.repeat(loader)), run.device)

    model = run.program_model(torch.float32, train=True, remat=t['remat'])
    optimizer = make_optimizer(model.parameters(), t['learning_rate'])
    step = make_train_step(model, model.config, optimizer, accum, run.compute_dtype())
    names = {p: n for n, p in model.named_parameters()}
    decisions = ((criterion, 'hungarian_match', lambda args, out: out.cpu()),
                 (criterion, '_uncertainty_points', lambda args, out: out.cpu()),
                 (transformer_decoder, 'masked_attention', lambda args, out: args[3].cpu()))

    # the first micro-steps, through the window's own call and feed; the
    # reference follows the program's decisions in them
    first = {'losses': [], 'assigned': [], 'points': [], 'masks': []}
    for k in range(t['warmup_micro_steps']):
        into = ([], [], []) if k < t['check_micro_steps'] else None
        with contextlib.ExitStack() as stack:
            if into is not None:  # the matcher's, the point sampler's, the masks' decisions
                for (module, attr, pick), sink in zip(decisions, into):
                    stack.enter_context(spans.recording(module, attr, sink, pick))
            loss = step(next(feed), draws(run, k))
        if into is not None:
            # one matcher call a micro-step; any other count cannot be followed
            first['assigned'].append(into[0][0] if len(into[0]) == 1 else torch.empty(0))
            first['points'].append(into[1])
            first['masks'].append(into[2])
        if k < t['check_micro_steps']:
            first['losses'].append(float(loss))
        if k + 1 == accum:  # the first update: its gradient, as AdamW's first moment holds it
            first['grad'] = leaf_norms({names[p]: s['exp_avg'] / (1 - 0.9)
                                        for p, s in optimizer.state.items()})
        if k + 1 == t['check_micro_steps']:
            start = run.state_dict(torch.float32)
            first['change'] = leaf_norms({n: p.detach() - start[n]
                                          for n, p in model.named_parameters()})
            del start
    run.set_up_done()

    waits, losses, updates, update_s, collecting = [], [], 0, [], []

    def on_gc(phase, info):  # the host's own pauses, for the spread of the rate
        collecting.append(time.perf_counter() * (1 if phase == 'stop' else -1))

    micro = t['warmup_micro_steps']
    gc.callbacks.append(on_gc)
    start, cpu = time.perf_counter(), time.process_time()
    while True:
        for _ in range(accum):
            t0 = time.perf_counter()
            b = next(feed)
            waits.append(time.perf_counter() - t0)
            losses.append(step(b, draws(run, micro)))
            micro += 1
        run.synchronize()
        updates += 1
        done = time.perf_counter()
        update_s.append(done - start - sum(update_s))
        if done - start >= run.seconds:
            break
    gc.callbacks.remove(on_gc)
    images = updates * accum * batch
    run.window.update({'train_img_per_s': images / (done - start), 'updates': updates,
                       'micro_steps': updates * accum, 'images': images,
                       'elapsed_s': done - start, 'input_wait_s': sum(waits),
                       'host_cpu_s': time.process_time() - cpu,
                       'gc_s': sum(collecting[:len(collecting) // 2 * 2]),
                       'update_s_quartiles': [float(q) for q in np.percentile(update_s,
                                                                               [25, 50, 75])],
                       'update_s_max': max(update_s)})
    run.attempted = len(losses)
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    run.read_peak()

    if run.trace:
        calls = []

        def one_update():
            for j in range(accum):
                step(next(feed), draws(run, micro + j))

        with spans.msda_ranges(calls):
            run.slice = tracing.capture(one_update, accum, run.synchronize)
        run.slice.msda_calls = calls

    del step, optimizer, model, feed, loader
    cache.cleanup()
    if run.cuda:
        torch.cuda.empty_cache()
    ref = reference_steps(run, samples, ref_model.Numerics('float32'), forced=first)
    gaps, where = compare.train_gaps(first, ref)
    compare.hold(run, gaps)
    run.notes.update(where)


def reference_steps(run, samples: SynthTrain, numerics, fault=None, forced=None) -> dict:
    """The reference's first ``check_micro_steps`` micro-steps from the
    benchmark's weights, on the rows the feed gives them, with the same
    draws, and an AdamW update after every ``accumulation`` of them: their
    losses, the first update's gradient norms, each parameter's change, and
    the decisions it took (``assigned``, ``points``, ``masks``, one entry a
    micro-step). Where ``forced`` gives such decisions, it follows them,
    and reads how far they lie from its own: ``match_excess`` (each
    assignment problem's) and ``match_gap``, ``point_gap``, ``mask_gap``
    (the largest), and the counts of decisions that differ from its own
    (``point_flips`` of ``point_decisions``, ``mask_flips`` of
    ``mask_decisions``), with their tallies by the reference's margin
    (``point_tally``, ``mask_tally``).
    ``fault`` ('half_batch') plants a fault."""
    t, cfg = run.traffic, run.config
    batch, accum = t['batch'], t['accumulation']
    model = run.reference_model(run.device)
    model.load_state_dict(run.state_dict(torch.float32))
    model.train()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    params = list(model.parameters())
    moments = {}
    counts = ('point_flips', 'point_decisions', 'mask_flips', 'mask_decisions')
    tallies = ('point_tally', 'mask_tally')
    out = {'losses': [], 'assigned': [], 'points': [], 'masks': [], 'match_excess': [],
           'match_gap': 0.0, 'point_gap': 0.0, 'mask_gap': 0.0, **dict.fromkeys(counts, 0),
           **{key: [0] * (len(ref_model.MARGINS) + 1) for key in tallies}}
    with ref_model.float32_products():
        for k in range(t['check_micro_steps']):
            rows = [samples.arrays((k * batch + j) % len(samples)) for j in range(batch)]
            if fault == 'half_batch':
                rows = rows[:batch // 2]
            pixels, masks, labels = (torch.from_numpy(np.stack(a)).to(run.device)
                                     for a in zip(*rows))
            gen = draws(run, k).generator
            seen = {} if forced is None else {'forced': forced['masks'][k]}
            class_list, mask_list = model(pixels, numerics, gen, seen)
            probe = {} if forced is None else {'forced': forced['assigned'][k],
                                               'points': forced['points'][k]}
            loss = ref_criterion.total_loss(class_list, mask_list, masks.float(), labels, gen,
                                            {**cfg, **t}, probe)
            out['assigned'].append(probe['assigned'])
            out['points'].append(probe['points_used'])
            out['masks'].append([m.cpu() for m in seen['masks']])
            for key, where in (('match_gap', probe), ('point_gap', probe), ('mask_gap', seen)):
                out[key] = max(out[key], where.get(key, 0.0))
            for key in counts:
                out[key] += probe.get(key, seen.get(key, 0))
            for key in tallies:
                add = probe.get(key, seen.get(key))
                if add is not None:
                    out[key] = [a + c for a, c in zip(out[key], add)]
            out['match_excess'] += probe.get('match_excess', [])
            (loss / accum).backward()
            out['losses'].append(loss.item())
            if (k + 1) % accum == 0:
                if k + 1 == accum:
                    out['grad'] = leaf_norms({n: p.grad for n, p in model.named_parameters()})
                ref_criterion.adamw_update(params, moments, t['learning_rate'])
                for p in params:
                    p.grad = None
    out['change'] = leaf_norms({n: p.detach() - start[n] for n, p in model.named_parameters()})
    del model, start, params, moments
    if run.cuda:
        torch.cuda.empty_cache()
    return out
