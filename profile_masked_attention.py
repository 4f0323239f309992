"""Device time of each launch of the bf16 masked-attention backward on an
NVIDIA GPU, at the decoder's shapes (B 2, H 8, Q 200, D 32, 70 % masked) for
S in {10000, 2500, 625}, with the dQ launch's key split as the wrapper picks
it and at other chunk counts:

    python3 profile_masked_attention.py [--chunks 4 8 16 32]

Each line is one (S, chunk count): the device µs per call of each kernel
over 20 backward calls in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import argparse
import sys

import torch

import weed_instance_segmentation_tpu_torch.ops.masked_attention as ops
from chip_smoke import device_split, kernel_name

RUNS = 20


def profile(s: int, chunks: int | None) -> str:
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(s)
    b, heads, nq, d = 2, 8, 200, 32
    q = (torch.randn((b, heads, nq, d), generator=g, device=dev) * d ** -0.5).bfloat16()
    k, v = (torch.randn((b, heads, s, d), generator=g, device=dev).bfloat16() for _ in range(2))
    mask = torch.rand((b, 1, nq, s), generator=g, device=dev) < 0.7
    mask &= ~mask.all(dim=-1, keepdim=True)
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    pick = ops.dq_chunks
    if chunks:
        ops.dq_chunks = lambda *_: chunks
    try:
        out = ops.masked_attention(*ins, mask)
        cot = torch.randn_like(out)
        split = device_split(lambda: torch.autograd.grad(out, ins, cot, retain_graph=True), RUNS)
    finally:
        ops.dq_chunks = pick
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    used = chunks or pick(b * heads, nq, s, sms)
    return f'S={s} chunks={used}: ' + '; '.join(
        f'{kernel_name(key)} {1e3 * ms:.1f} µs' for key, ms in split.most_common())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--chunks', type=int, nargs='*', default=[],
                        help='dQ key-chunk counts to try besides the wrapper\'s own')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('profile_masked_attention: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    for s in (10000, 2500, 625):
        for chunks in [None, *args.chunks]:
            if chunks and chunks > -(-s // ops.KEY_TILE):
                continue
            print(profile(s, chunks), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
