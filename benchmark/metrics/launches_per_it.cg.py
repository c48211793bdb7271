"""Device kernel launches a CG iteration (solve/cg.py pcg with the Jacobi
preconditioner, the fused J.v and the restriction): launches in the traced
window over the CG iterations it holds."""


def read(run):
    t = run["trace"]
    if not t or not t.get("cg_iterations"):
        return None
    return t["launches"] / t["cg_iterations"]
