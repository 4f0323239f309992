"""The post-process kernel's share of its roofline in the traced requests."""

from bench_torch.readers import POSTPROCESS, op_roofline


def read(run):
    return op_roofline(run, POSTPROCESS)
