"""MSDA's share of its roofline in the traced requests."""

from bench_torch.readers import msda_roofline


def read(run):
    return msda_roofline(run)
