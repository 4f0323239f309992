"""Device time of each launch of the bf16 masked-attention forward and
backward on an NVIDIA GPU, at the decoder's shapes (H 8, Q 200, D 32, 70 %
masked; B 2 for S in {10000, 2500, 625}, and the serving batch B 4 at
S 10000), with the key split as the wrapper picks it and at other chunk
counts:

    python3 profile_masked_attention.py [--chunks 4 8 16 32]

Each line is one (B, S, chunk count, forward or backward): the device µs per
call of each kernel over 20 calls in a ``torch.profiler`` trace. The chunk
count applies to the forward and to the backward's dQ launch alike.
"""

from __future__ import annotations

import argparse
import sys

import torch

import weed_instance_segmentation_tpu_torch.ops.masked_attention as ops
from chip_smoke import device_split, kernel_name, masked_inputs

RUNS = 20
SHAPES = ((2, 10000), (2, 2500), (2, 625), (4, 10000))  # (batch, keys)


def profile(b: int, s: int, chunks: int | None) -> list[str]:
    dev = torch.device('cuda')
    q, k, v, mask = masked_inputs(dev, b, s)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    pick = ops.key_chunks
    if chunks:
        ops.key_chunks = lambda *_: chunks
    try:
        with torch.no_grad():
            fwd = device_split(lambda: ops.masked_attention(q, k, v, mask), RUNS)
        out = ops.masked_attention(*ins, mask)
        cot = torch.randn_like(out)
        bwd = device_split(lambda: torch.autograd.grad(out, ins, cot, retain_graph=True), RUNS)
    finally:
        ops.key_chunks = pick
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    used = chunks or pick(b * q.shape[1], q.shape[2], s, sms)
    return [f'B={b} S={s} chunks={used} {name}: ' + '; '.join(
        f'{kernel_name(key)} {1e3 * ms:.1f} µs' for key, ms in split.most_common())
        for name, split in (('fwd', fwd), ('bwd', bwd))]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--chunks', type=int, nargs='*', default=[],
                        help='key-chunk counts to try besides the wrapper\'s own')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_masked_attention: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    for b, s in SHAPES:
        for chunks in [None, *args.chunks]:
            if chunks and chunks > -(-s // ops.KEY_TILE):
                continue
            print('\n'.join(profile(b, s, chunks)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
