"""Device ms a micro-step of work launched in the train step's ``backward`` range
(remat's recompute included)."""

from bench_torch.readers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, 'backward')
