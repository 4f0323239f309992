"""Host ms a micro-step of the window in the program's span ``forward``: the
forward's dispatch."""

from bench_torch.program_spans import host_ms_per_micro_step


def read(run):
    return host_ms_per_micro_step(run, 'forward')
