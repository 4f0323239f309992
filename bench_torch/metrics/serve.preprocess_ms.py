"""Device ms a request of work launched in the program's span ``serve.preprocess``
(the fused pre-process) in the traced requests."""

from bench_torch.readers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, 'serve.preprocess')
