"""Wall ms a CG iteration with its V-cycle (solve/cg.py, solve/pmg.py,
solve/amg.py apply): sum of (solve_time - pc_time) over sum of
ksp_iters in the window."""

from benchmark.readers import untraced


def read(run):
    recs = untraced(run["records"])
    its = sum(r["ksp"] for r in recs)
    if not its:
        return None
    return 1e3 * sum(r["solve_s"] - r["pc_s"] for r in recs) / its
