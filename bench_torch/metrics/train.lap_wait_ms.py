"""Host ms a micro-step of the window in the program's span ``lap.wait``: the host
LAP's blocking copy of the stacked costs, which waits for the device to drain
what was queued before it (the forward and the matcher's costs)."""

from bench_torch.program_spans import host_ms_per_micro_step


def read(run):
    return host_ms_per_micro_step(run, 'lap.wait')
