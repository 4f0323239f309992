"""Host ms a micro-step of the window in the program's span ``lap.solve``: scipy's
solves of every (layer, image) assignment and the copy of the answers back."""

from bench_torch.program_spans import host_ms_per_micro_step


def read(run):
    return host_ms_per_micro_step(run, 'lap.solve')
