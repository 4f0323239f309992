"""Host ms a micro-step of the window in the program's span ``optimizer``: each
update's host ms spread over its micro-steps."""

from bench_torch.program_spans import host_ms_per_micro_step


def read(run):
    return host_ms_per_micro_step(run, 'optimizer')
