"""Readings that set the limits of ``bench_torch/limits/<cell>.json``.

    python3 bench_torch/control.py --workload <cell> --mode <mode> --seeds <n> [<n> ...]
        [--seconds <s>]

Modes, each printing one JSON line of numbers a seed:

- ``program``: the cell's own runs (its window of ``--seconds``, its
  checks), one seed after another in this process; the largest reading of
  sound runs is a limit's lower end;
- ``control``: the reference put in the program's place and computed one
  precision step below the configuration's bfloat16 (under bfloat16
  autocast, every product's operands and results in float8 e4m3 and its
  gradients in e5m2), against the float32 reference, which follows its
  decisions; its smallest reading is a limit's upper end;
- ``half_batch``: the reference with half of each batch left out (training:
  the loss's mean over the rest; serving: the first half's answers given
  for the second half);
- ``altered``: serving's answer altered where it is produced (the first
  image's scores lowered by a tenth);
- ``reference``: the float32 reference against itself, which reads 0.

The benchmark's own runs never run these. They run at the cell's own
sizes on the card; the tests run them at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ('program', 'control', 'half_batch', 'altered', 'reference')


def reference_readings(run, mode: str) -> dict:
    """The numbers the cell compares, with the reference (float32) as the
    program and the reference in ``mode`` as its answer."""
    import torch

    from bench_torch import compare, harness
    from bench_torch.reference import model as ref_model
    from bench_torch.reference.postprocess import answers

    t = run.traffic
    if t['driver'] == 'train':
        train = harness.load_module('drivers', 'train')
        samples = train.SynthTrain(run.seed, t['cache_samples'], t, run.config['num_labels'])
        numerics = ref_model.Numerics('fp8' if mode == 'control' else 'float32')
        got = train.reference_steps(run, samples, numerics,
                                    fault='half_batch' if mode == 'half_batch' else None)
        want = train.reference_steps(run, samples, ref_model.Numerics('float32'),
                                     forced=None if mode == 'half_batch' else got)
        return compare.train_gaps(got, want)[0]
    serve = harness.load_module('drivers', 'serve')
    pool = serve.make_pool(run, t)[:t['check_requests']]
    numerics = ref_model.Numerics('fp8' if mode == 'control' else 'float32')
    reference = run.reference_model(run.device)
    reference.load_state_dict({k: v.float() for k, v in run.state_dict(
        run.compute_dtype()).items()})
    reference.eval()
    served, masks = [], []
    with torch.no_grad(), ref_model.float32_products():
        for raw in pool:
            pixels = ref_model.preprocess(raw.to(run.device), tuple(t['model_hw']))
            probe = {}
            class_logits, mask_logits = reference(pixels, numerics, probe=probe)
            masks.append([m.cpu() for m in probe['masks']])
            got = answers(class_logits[-1], mask_logits[-1], tuple(t['model_hw']),
                          t['threshold'])
            got = {k: got[k] for k in serve.RESULT_KEYS}
            if mode == 'half_batch':
                half = got['scores'].shape[0] // 2
                got = {k: torch.cat([v[:half]] * 2) for k, v in got.items()}
            if mode == 'altered':
                got['scores'] = got['scores'].clone()
                got['scores'][0] *= 0.9
            served.append({k: v.cpu() for k, v in got.items()})
    del reference
    # the reference in the program's place is not served twice
    return {**serve.check_requests(run, pool, served, masks), 'replay_diff': 0.0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--mode', choices=MODES, required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--seconds', type=float, default=5.0)
    args = parser.parse_args(argv)
    sys.path[:1] = [ROOT]  # the checkout's root, not this directory
    from bench_torch import harness

    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(args.workload, seed, args.seconds, False, t0)
        run.open_device()
        if args.mode == 'program':  # the cell's own run, with every number it computes
            harness.load_module('drivers', run.traffic['driver']).run(run)
            numbers = {**{k: v for k, (v, _) in run.checks.items()},
                       **{k: v for k, v in run.notes.items() if isinstance(v, (float, list))},
                       'correct': run.correct(), 'failed': run.failed}
        else:
            numbers = reference_readings(run, args.mode)
        print(json.dumps({'workload': args.workload, 'mode': args.mode, 'seed': seed,
                          'seconds': time.perf_counter() - t0, **numbers}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
