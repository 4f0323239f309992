"""Host ms a micro-step of the window in the program's span ``backward``: the
backward's dispatch (remat's recompute included), and any wait for the device."""

from bench_torch.program_spans import host_ms_per_micro_step


def read(run):
    return host_ms_per_micro_step(run, 'backward')
