"""Seconds of the p-multigrid set-up a solve (problem.py build_mg_levels
with the native-level stashes, the level diagonals, the Chebyshev
eigenvalue estimates: the program's pc/mg/* spans), the window's mean;
with amg_refresh_s.solve it makes up the preconditioner set-up."""

from benchmark.spans import window_requests


def read(run):
    recs = window_requests("solve")
    if not recs:
        return None
    return sum(sum(s for k, s in r["seconds"].items()
                   if k.startswith("pc/mg/"))
               for r in recs) / len(recs)
