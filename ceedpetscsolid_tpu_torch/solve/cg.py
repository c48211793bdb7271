"""Matrix-free preconditioned conjugate gradients.
Port of `pcg` from ceedpetscsolid_tpu/solve/cg.py.

The KSPCG analog with KSP_NORM_NATURAL and rtol 1e-10 defaults (reference
elasticity.c:504-507): convergence is monitored in the natural norm
sqrt(r . M^{-1} r). The loop runs eagerly on the host; each iteration
reads two float64 scalars back (one device sync) to test convergence, where
the JAX version kept the whole loop on the device in a lax.while_loop.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..utils.precise import dot2


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rnorm: float                # final natural norm
    converged: bool


def pcg(
    A: Callable,
    b: torch.Tensor,
    M_inv: Callable | None = None,
    x0: torch.Tensor | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-50,
    maxiter: int = 10_000,
    stall_its: int = 60,
    monitor: bool = False,
) -> CGResult:
    """Solve A x = b with preconditioner M_inv (defaults to identity).

    stall_its: abandon the solve once the natural norm has not dropped 5%
    below its anchor for this many consecutive iterations (the f32
    attainable-accuracy stagnation guard of the JAX version).
    A non-positive p.Ap (KSP_DIVERGED_INDEFINITE_MAT analog) ends the solve
    with converged=False, keeping the iterate of the last good step.
    """
    if M_inv is None:
        M_inv = lambda r: r  # noqa: E731
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()                 # A(0) = 0 for the linear operators here
    else:
        x = x0
        r = b - A(x)
    z = M_inv(r)
    rz = dot2(r, z)
    norm0 = math.sqrt(abs(float(rz)))
    tol = max(rtol * norm0, atol)

    p = z
    it, ok, anchor, since = 0, True, norm0, 0
    rn = norm0
    while ok and rn > tol and it < maxiter and since < stall_its:
        Ap = A(p)
        pAp = dot2(p, Ap)
        good_t = pAp > 0
        alpha = torch.where(good_t, rz / pAp, torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = dot2(r, z)
        beta = rz_new / rz
        p = z + beta * p
        pAp_v, rz_v = torch.stack([pAp, rz_new]).tolist()   # the one sync
        rn = math.sqrt(abs(rz_v))
        if monitor:
            # -ksp_monitor analog (natural norm, like KSP_NORM_NATURAL)
            print(f"  {it + 1} KSP Residual norm {rn}")
        # windowed stagnation: the norm must drop 5% below the anchor
        # within stall_its iterations or the solve is abandoned
        if rn < 0.95 * anchor:
            anchor, since = rn, 0
        else:
            since += 1
        rz = rz_new
        it += 1
        ok = pAp_v > 0
    # The JAX version's first-iteration fallback to M^{-1} b tests
    # `(it == 0) & ~ok`, which never holds (`it` counts the bailed
    # iteration), so a first-iteration bail returns x = 0 there; the port
    # keeps that behaviour for parity.
    return CGResult(x=x, iters=it, rnorm=rn, converged=ok and rn <= tol)
