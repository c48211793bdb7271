"""Preconditioner set-up's share of the solve (problem.py mg_setup,
refresh_amg; ops/operator.make_diagonal; solve/cg.estimate_extreme_eigs):
sum of SolveInfo.pc_time over sum of solve_time in the window, in %."""

from benchmark.readers import untraced


def read(run):
    recs = untraced(run["records"])
    total = sum(r["solve_s"] for r in recs)
    return 100.0 * sum(r["pc_s"] for r in recs) / total if total else None
