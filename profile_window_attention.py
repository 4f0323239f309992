"""Device time of each launch of the bf16 window-attention kernels on an
NVIDIA GPU, at Swin-L's shapes (window 12: T 144, D 32; stage 1 H 6 and
stage 3 H 24), with and without the shift mask:

    python3 profile_window_attention.py [--runs 44 66]

Each line is one (stage, mask, pass) and gives the device µs per call of
each kernel, copy or fill by name over 20 calls in a ``torch.profiler``
trace. The forward runs at training batch 2 (NW 578 and 50) and at the
serving batch 4 (NW 1156 and 100); the backward at batch 2, with the runs
of windows as the wrapper picks them and at each ``--runs`` count.
"""

from __future__ import annotations

import argparse
import sys

import torch

import weed_instance_segmentation_tpu_torch.ops.window_attention as ops
from chip_smoke import (
    SERVING_WINDOW_STAGES, WINDOW_STAGES, device_split, kernel_name, window_inputs,
)

RUNS = 20


def _inputs(stage: str, shifted: bool) -> tuple:
    q, k, v, bias, mask = window_inputs(torch.device('cuda'),
                                        *{**WINDOW_STAGES, **SERVING_WINDOW_STAGES}[stage])
    q, k, v = (x.bfloat16().requires_grad_(True) for x in (q, k, v))
    return q, k, v, bias.requires_grad_(True), mask if shifted else None


def _split_line(split) -> str:
    return '; '.join(f'{kernel_name(key)} {1e3 * ms:.1f} µs' for key, ms in split.most_common())


def profile_forward(stage: str, shifted: bool) -> str:
    q, k, v, bias, mask = _inputs(stage, shifted)
    with torch.no_grad():
        split = device_split(lambda: ops.window_attention(q, k, v, bias, mask), RUNS)
    return (f'{stage} NW={q.shape[0]} H={q.shape[1]} {"shifted" if shifted else "unshifted"} '
            f'fwd: {_split_line(split)}')


def profile_backward(stage: str, shifted: bool, runs: int | None) -> str:
    q, k, v, bias, mask = _inputs(stage, shifted)
    nw, heads = q.shape[:2]
    if runs and runs > nw:
        return f'{stage}: runs={runs} is more than its {nw} windows; skipped'
    pick = ops.window_runs
    if runs:
        ops.window_runs = lambda *_: runs
    try:
        out = ops.window_attention(q, k, v, bias, mask)
        cot = torch.randn_like(out)
        ins = [q, k, v, bias]
        split = device_split(lambda: torch.autograd.grad(out, ins, cot, retain_graph=True), RUNS)
    finally:
        ops.window_runs = pick
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    used = runs or pick(nw, heads, sms)
    return (f'{stage} NW={nw} H={heads} {"shifted" if shifted else "unshifted"} bwd '
            f'runs={used}: {_split_line(split)}')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--runs', type=int, nargs='*', default=[],
                        help='backward run counts to try besides the wrapper\'s own')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_window_attention: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    for stage in {**WINDOW_STAGES, **SERVING_WINDOW_STAGES}:
        for shifted in (True, False):
            print(profile_forward(stage, shifted), flush=True)
            if stage in WINDOW_STAGES:
                for runs in [None, *args.runs]:
                    print(profile_backward(stage, shifted, runs), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
