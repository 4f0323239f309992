"""Host ms a batch of the window in the program's span ``loader.collate``: a batch
read from the cache and collated, on the loader's prefetch thread."""

from bench_torch.program_spans import host_ms_per_span


def read(run):
    return host_ms_per_span(run, 'loader.collate')
