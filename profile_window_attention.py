"""Device time of each launch of the bf16 window-attention backward on an
NVIDIA GPU, at Swin-L's training shapes (batch 2, window 12: T 144, D 32;
stage 1 NW 578, H 6 and stage 3 NW 50, H 24), with and without the shift
mask, with the runs of windows as the wrapper picks them and at other run
counts:

    python3 profile_window_attention.py [--runs 44 66]

Each line is one (stage, mask, run count): the device µs per call of each
kernel over 20 backward calls in a ``torch.profiler`` trace, and the
forward's beside it.
"""

from __future__ import annotations

import argparse
import sys

import torch

import weed_instance_segmentation_tpu_torch.ops.window_attention as ops
from chip_smoke import WINDOW_STAGES, TRAIN_BATCH, device_split, kernel_name
from weed_instance_segmentation_tpu_torch.models.swin import shifted_window_attn_mask

RUNS = 20
WINDOW, HEAD_DIM = 12, 32


def profile(stage: str, shifted: bool, runs: int | None) -> str:
    dev = torch.device('cuda')
    hp, heads = WINDOW_STAGES[stage]
    t, nw = WINDOW * WINDOW, TRAIN_BATCH * (hp // WINDOW) ** 2
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((nw, heads, t, HEAD_DIM), generator=g, device=dev).bfloat16()
               .requires_grad_(True) for _ in range(3))
    bias = torch.randn((heads, t, t), generator=g, device=dev).requires_grad_(True)
    mask = torch.from_numpy(shifted_window_attn_mask(hp, hp, WINDOW, WINDOW // 2)).to(dev) \
        if shifted else None
    if runs and runs > nw:
        return f'{stage}: runs={runs} is more than its {nw} windows; skipped'
    pick = ops.window_runs
    if runs:
        ops.window_runs = lambda *_: runs
    try:
        with torch.no_grad():
            fwd = device_split(lambda: ops.window_attention(q, k, v, bias, mask), RUNS)
        out = ops.window_attention(q, k, v, bias, mask)
        cot = torch.randn_like(out)
        ins = [q, k, v, bias]
        bwd = device_split(lambda: torch.autograd.grad(out, ins, cot, retain_graph=True), RUNS)
    finally:
        ops.window_runs = pick
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    used = runs or pick(nw, heads, sms)
    return (f'{stage} NW={nw} H={heads} {"shifted" if shifted else "unshifted"} runs={used} bwd: '
            + '; '.join(f'{kernel_name(key)} {1e3 * ms:.1f} µs' for key, ms in bwd.most_common())
            + f' | fwd {1e3 * sum(fwd.values()):.1f} µs')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--runs', type=int, nargs='*', default=[],
                        help='run counts to try besides the wrapper\'s own')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_window_attention: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    for stage in WINDOW_STAGES:
        for shifted in (True, False):
            for runs in [None, *args.runs]:
                print(profile(stage, shifted, runs), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
