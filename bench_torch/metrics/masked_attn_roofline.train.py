"""The masked-attention kernels' share of their roofline, forward and
backward, in the traced update."""

from bench_torch.readers import MASKED, op_roofline


def read(run):
    return op_roofline(run, MASKED)
