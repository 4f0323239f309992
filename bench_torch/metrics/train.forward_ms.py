"""Device ms a micro-step of work launched in the train step's ``forward`` range."""

from bench_torch.readers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, 'forward')
