"""Faults planted on the distributed cell's ranks (the `patch` of
benchmark/kinds/dist_solve.run, called first on every rank), each keeping
the ranks' collectives in step so that the run ends and is judged."""

from __future__ import annotations


def unchanged_step(rank: int) -> None:
    """Each Newton step on rank 1 returns that rank's state unchanged, and
    every rank takes the step as converged."""
    from ceedpetscsolid_tpu_torch.parallel.driver import DistributedProblem

    step = DistributedProblem.newton_step

    def faulty(self, u_owned, *a, **kw):
        u_new, rnorm_in, _, its, step_norm, unorm = step(self, u_owned, *a,
                                                         **kw)
        return (u_owned if rank == 1 else u_new, rnorm_in, 0.0, its,
                step_norm, unorm)

    DistributedProblem.newton_step = faulty


def altered_answer(rank: int) -> None:
    """Rank 0's answer has one displacement altered."""
    from ceedpetscsolid_tpu_torch.parallel.driver import DistributedProblem

    solve = DistributedProblem.solve

    def faulty(self, *a, **kw):
        u, info = solve(self, *a, **kw)
        if rank == 0:
            u = u.copy()
            u[0, u.shape[1] // 2] += 0.1 * float(abs(u).max())
        return u, info

    DistributedProblem.solve = faulty


def native_refresh(rank: int) -> None:
    """Rank 0 refreshes its AMG through the host's native setup at every
    Newton step, as before the device refresh."""
    from ceedpetscsolid_tpu_torch.solve.amg import AMGPreconditioner

    if rank == 0:
        AMGPreconditioner.refreshes_from = lambda self, source: False
