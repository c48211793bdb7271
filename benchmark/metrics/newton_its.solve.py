"""Newton iterations a solve (solve/newton.py; SolveInfo.snes_iters),
the window's mean."""

from benchmark.readers import untraced


def read(run):
    recs = untraced(run["records"])
    return sum(r["snes"] for r in recs) / len(recs) if recs else None
