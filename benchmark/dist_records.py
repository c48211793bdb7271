"""What the distributed cell's per-layer readers share
(benchmark/metrics/*.dist.py): the one-card cell's readers, over rank 0's
records of the window's requests, which benchmark/kinds/dist_solve.py
sends back with the program's solve, pc and AMG refresh seconds under
the one-card cell's names (the process that runs the harness holds no
spans)."""

from __future__ import annotations

from . import common


def one_card(metric: str):
    """read(run) of the reader benchmark/metrics/<metric>.py over the
    requests that carry the program's seconds; None where none does (a
    program that keeps no record of its distributed solve)."""
    read = common.reader(metric)

    def dist_read(run):
        recs = [q for q in run["records"] if "solve_s" in q]
        return read({**run, "records": recs}) if recs else None

    return dist_read
