"""MSDA's share of its roofline, forward and backward, in the traced update."""

from bench_torch.readers import msda_roofline


def read(run):
    return msda_roofline(run)
