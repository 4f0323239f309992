"""Host ms a micro-step of the window in the program's span ``loader.to_device``:
the batch pinned and its copies to the device enqueued."""

from bench_torch.program_spans import host_ms_per_micro_step


def read(run):
    return host_ms_per_micro_step(run, 'loader.to_device')
