"""CG iterations a solve (solve/cg.py with the p-MG V-cycle;
SolveInfo.ksp_iters), the window's mean."""

from benchmark.readers import untraced


def read(run):
    recs = untraced(run["records"])
    return sum(r["ksp"] for r in recs) / len(recs) if recs else None
