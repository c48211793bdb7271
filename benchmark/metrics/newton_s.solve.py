"""Seconds a solve spends outside the preconditioner set-up and CG
(solve/newton.py, problem.py: residuals, line search, norms, the
continuation): the program's solve span less its pc and cg spans, the
window's mean."""

from benchmark.spans import window_requests


def read(run):
    recs = window_requests("solve")
    if not recs:
        return None
    return sum(r["seconds"]["solve"] - r["seconds"].get("pc", 0.0)
               - r["seconds"].get("cg", 0.0) for r in recs) / len(recs)
