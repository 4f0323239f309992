"""Device ms a request of work launched in the benchmark's range around the
backbone's forward."""

from bench_torch.readers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, 'bench.backbone')
