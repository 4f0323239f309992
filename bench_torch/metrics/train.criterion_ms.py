"""Host ms a micro-step in the train step's ``criterion`` range: the loss, with
the host assignment's wait for its costs."""

from bench_torch.readers import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, 'criterion')
