"""Host ms issuing one CG iteration (solve/cg.py pcg with the Jacobi
preconditioner): the program's cg/iter spans less the cg/wait spans
around each iteration's read, over the CG iterations, in the window's
untraced requests."""

from benchmark.spans import window_requests


def read(run):
    recs = window_requests("linear_solve")
    if not recs:
        return None
    its = sum(r["counts"].get("cg.iterations", 0) for r in recs)
    busy = sum(r["seconds"].get("cg/iter", 0.0)
               - r["seconds"].get("cg/wait", 0.0) for r in recs)
    return 1e3 * busy / its if its else None
