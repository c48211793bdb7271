"""The card's idle share of the traced window (rank 0's in the
distributed cell): 1 - the union of the profiler's device intervals over
the window's wall, in %."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
