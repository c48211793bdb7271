"""p-multigrid V-cycle preconditioner (reference elasticity.c:524-590).
Port of ceedpetscsolid_tpu/solve/pmg.py.

Multiplicative V-cycle over the p-coarsening level hierarchy with 3
pre/post Chebyshev(Jacobi) smooths per level (PCMGSetNumberSmooth(3),
elasticity.c:589), Gauss-Lobatto coarse-to-fine prolongation with
multiplicity scaling (matops.c:115-157), and a fixed-polynomial coarse
solve. Everything is a fixed linear operation in the input, so the cycle is
a valid stationary preconditioner for the outer CG.

The coarse solve is a coarse_apply callable when one is given (the AMG
V-cycle, not ported yet), else a heavy Chebyshev polynomial at p = 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .cg import chebyshev


@dataclass
class MGLevel:
    """Static per-level data; A/diag depend on the current Newton state."""

    apply: Callable             # (v, stash) -> A_l v, BC-masked
    mask: torch.Tensor          # (3, nnodes_l) bool, constrained
    prolong: Callable | None    # from level l-1 (None at the coarsest)
    restrict: Callable | None   # to level l-1


def make_vcycle(
    levels: list[MGLevel],
    smooth_its: int = 3,
    coarse_cheb_its: int = 30,
    coarse_apply: Callable | None = None,
):
    """Returns vcycle(b, stash, diag_invs, bounds, coarse_data) ->
    approx A_fine^{-1} b.

    diag_invs: list of (3, nnodes_l) inverse diagonals per level.
    bounds: list of (lam_min, lam_max) Chebyshev intervals per level.
    coarse_apply: optional (b0, coarse_data) -> x0 coarse solver; None
    means a heavy Chebyshev polynomial at p = 1.
    """
    nlev = len(levels)

    def vcycle(b, stash, diag_invs, bounds, coarse_data=None):
        bs = [None] * nlev
        xs = [None] * nlev
        bs[-1] = b
        # downward: pre-smooth + restrict residual
        for l in range(nlev - 1, 0, -1):
            lvl = levels[l]
            A = lambda v, l=l: levels[l].apply(v, stash)  # noqa: E731
            lo, hi = bounds[l]
            xs[l] = chebyshev(A, bs[l], diag_invs[l], lo, hi, smooth_its)
            bc = lvl.restrict(bs[l] - A(xs[l]))
            bs[l - 1] = torch.where(levels[l - 1].mask, 0.0, bc)
        # coarse solve (elasticity.c:568-585)
        if coarse_apply is not None:
            xs[0] = torch.where(levels[0].mask, 0.0,
                                coarse_apply(bs[0], coarse_data))
        else:
            lo0, hi0 = bounds[0]
            xs[0] = chebyshev(lambda v: levels[0].apply(v, stash), bs[0],
                              diag_invs[0], lo0, hi0, coarse_cheb_its)
        # upward: prolong + post-smooth
        for l in range(1, nlev):
            lvl = levels[l]
            x = xs[l] + torch.where(lvl.mask, 0.0, lvl.prolong(xs[l - 1]))
            A = lambda v, l=l: levels[l].apply(v, stash)  # noqa: E731
            lo, hi = bounds[l]
            xs[l] = chebyshev(A, bs[l], diag_invs[l], lo, hi, smooth_its,
                              x0=x)
        return xs[-1]

    return vcycle
