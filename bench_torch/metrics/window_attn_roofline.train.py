"""The window-attention kernels' share of their roofline, forward (remat's
recompute included) and backward, in the traced update."""

from bench_torch.readers import WINDOW, op_roofline


def read(run):
    return op_roofline(run, WINDOW)
