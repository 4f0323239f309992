"""Device time of each launch of the post-process kernel on an NVIDIA GPU at
the serving shape ((4, 200, 200, 200) f32 mask logits → 384²), for each
band height and block size:

    python3 profile_postprocess_stats.py [--band-rows 8 16 32 64] [--warps 3 6 12]

Each line is one (band rows, warps) and gives the band plan, the device µs
per call of each launch by name over 20 calls in a ``torch.profiler`` trace,
the achieved bytes per second against the byte bound, and the CUDA-event
median of the call (host launch time included). Every variant is first held
against the plain version (bins flip only at zero crossings, ``pos_cnt``
exact and ``sig_sum`` within rtol 1e-5 after the flips).
"""

from __future__ import annotations

import argparse
import sys

import torch

import weed_instance_segmentation_tpu_torch.ops.postprocess_kernel as ops
from bench_torch.roofline import HBM_BYTES_PER_S, postprocess
from chip_smoke import (
    SCORE_RESOLUTION, card_line, check_postprocess, device_split, kernel_name, postprocess_logits,
    timed_in_turns,
)

RUNS = 20


def profile(logits: torch.Tensor, band_rows: int, warps: int) -> str:
    """One variant: each band height is timed as asked, not halved to the
    wrapper's shared-memory target."""
    hm, wm = logits.shape[2:]
    plan = ops.band_plan(hm, wm, *SCORE_RESOLUTION, band_rows, ops.SHARED_LIMIT)
    threads = ops.block_threads(SCORE_RESOLUTION[1], warps)
    call = lambda: ops._launch(logits, SCORE_RESOLUTION, band_rows, warps,  # noqa: E731
                               ops.SHARED_LIMIT)
    check_postprocess(logits, call())
    split = device_split(call, RUNS)
    dev_ms = sum(split.values())
    moved = postprocess(*logits.shape, SCORE_RESOLUTION)[0]
    event_ms = timed_in_turns({'kernel': call})['kernel']
    launches = '; '.join(f'{kernel_name(key)} {1e3 * ms:.2f} µs' for key, ms in split.most_common())
    return (f'band_rows={plan[0]} bands={plan[1]} span_rows={plan[2]} threads={threads} '
            f'shared={ops.shared_layout(wm, SCORE_RESOLUTION[1], plan[0], plan[2])[2]} B: '
            f'{launches}; '
            f'device {dev_ms:.4f} ms = {moved / dev_ms / 1e6:.1f} GB/s, '
            f'{moved / HBM_BYTES_PER_S * 1e3 / dev_ms:.3f} of the byte bound; '
            f'event median {event_ms:.4f} ms')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--band-rows', type=int, nargs='*', default=[ops.BAND_ROWS])
    parser.add_argument('--warps', type=int, nargs='*', default=[ops.WARPS])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_postprocess_stats: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    print(card_line())
    logits = postprocess_logits(torch.device('cuda', 0))
    for band_rows in args.band_rows:
        for warps in args.warps:
            print(profile(logits, band_rows, warps), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
