"""The masked-attention kernel's share of its roofline in the traced requests."""

from bench_torch.readers import MASKED, op_roofline


def read(run):
    return op_roofline(run, MASKED)
