"""Share of the traced requests' wall time in which no device operation ran."""

from bench_torch.readers import idle_share


def read(run):
    return idle_share(run)
