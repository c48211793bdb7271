"""Matrix-free preconditioned conjugate gradients, the Chebyshev-Jacobi
smoother and its eigenvalue-bound estimate.
Port of ceedpetscsolid_tpu/solve/cg.py.

The KSPCG analog with KSP_NORM_NATURAL and rtol 1e-10 defaults (reference
elasticity.c:504-507): convergence is monitored in the natural norm
sqrt(r . M^{-1} r). The loop runs eagerly on the host; each iteration
reads two float64 scalars back (one device sync) to test convergence, where
the JAX version kept the whole loop on the device in a lax.while_loop.
`pcg` is the span "cg", each iteration "cg/iter" and its read "cg/wait",
with the counters cg.iterations and cg.reads (utils/timing).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.precise import dot2
from ..utils.timing import count, span


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rnorm: float                # final natural norm
    converged: bool
    # converged | indefinite (p.Ap <= 0) | stalled | max_it
    reason: str = "converged"


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
    dot: Callable = dot2,
) -> CGResult:
    """Solve A x = b with preconditioner M_inv (defaults to identity).

    stall_its: abandon the solve once the natural norm has not dropped 5%
    below its anchor for this many consecutive iterations (the f32
    attainable-accuracy stagnation guard of the JAX version).
    A non-positive p.Ap (KSP_DIVERGED_INDEFINITE_MAT analog) ends the solve
    with converged=False, keeping the iterate of the last good step.
    dot: the inner product, a 0-dim float64 tensor (the distributed driver
    passes its all-reduced dot).
    """
    with span("cg"):
        return _pcg(A, b, M_inv, x0, rtol, atol, maxiter, stall_its, monitor,
                    dot)


def _pcg(A, b, M_inv, x0, rtol, atol, maxiter, stall_its, monitor,
         dot) -> CGResult:
    if M_inv is None:
        M_inv = lambda r: r  # noqa: E731
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()                 # A(0) = 0 for the linear operators here
    else:
        x = x0
        r = b - A(x)
    z = M_inv(r)
    rz = dot(r, z)
    norm0 = math.sqrt(abs(float(rz)))
    tol = max(rtol * norm0, atol)

    p = z
    it, ok, anchor, since = 0, True, norm0, 0
    rn = norm0
    # one span object each, entered again every iteration
    iter_span, wait_span = span("cg/iter"), span("cg/wait")
    while ok and rn > tol and it < maxiter and since < stall_its:
        with iter_span:
            Ap = A(p)
            pAp = dot(p, Ap)
            good_t = pAp > 0
            alpha = torch.where(good_t, rz / pAp, torch.zeros_like(pAp))
            x = x + alpha * p
            r = r - alpha * Ap
            z = M_inv(r)
            rz_new = dot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            with wait_span:                                 # the one sync
                pAp_v, rz_v = torch.stack([pAp, rz_new]).tolist()
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
    count("cg.iterations", it)
    count("cg.reads", it + 1)
    # The JAX version's first-iteration fallback to M^{-1} b tests
    # `(it == 0) & ~ok`, which never holds (`it` counts the bailed
    # iteration), so a first-iteration bail returns x = 0 there; the port
    # keeps that behaviour for parity.
    reason = ("indefinite" if not ok else "converged" if rn <= tol else
              "stalled" if since >= stall_its else "max_it")
    return CGResult(x=x, iters=it, rnorm=rn, converged=ok and rn <= tol,
                    reason=reason)


def chebyshev(
    A: Callable,
    b: torch.Tensor,
    diag_inv: torch.Tensor,
    lam_min: float,
    lam_max: float,
    iters: int,
    x0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fixed-iteration Chebyshev smoothing for D^{-1}A on [lam_min, lam_max].

    The KSPCHEBYSHEV smoother analog (reference elasticity.c:538-552) with
    Jacobi (diagonal) preconditioning. A fixed polynomial in A, so it is a
    linear operation in b, safe inside an outer CG preconditioner.
    Standard three-term recurrence (Saad, Iterative Methods, alg. 12.1).
    The bounds are host floats: no device sync inside the recurrence.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta
    rho = 1.0 / sigma1

    r = b - A(x)
    d = (diag_inv * r) / theta
    x = x + d
    for _ in range(iters - 1):
        r = b - A(x)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (diag_inv * r)
        rho = rho_new
        x = x + d
    return x


def eig_start_vector(shape, dtype, device) -> torch.Tensor:
    """The 'noisy' right-hand side of estimate_extreme_eigs: uniform on
    [-0.5, 0.5) from numpy's default_rng(0). The JAX version draws it from
    jax.random.PRNGKey(0), whose bits torch cannot reproduce; a test hands
    this function JAX's numbers instead."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.uniform(size=shape) - 0.5, dtype=dtype,
                           device=device)


def estimate_extreme_eigs(
    A: Callable,
    diag_inv: torch.Tensor,
    shape,
    dtype,
    iters: int = 10,
    transform=(0.0, 0.1, 0.0, 1.1),
    r0: torch.Tensor | None = None,
    dot: Callable = dot2,
) -> tuple[float, float]:
    """Estimate eigenvalue bounds of D^{-1}A by a few CG/Lanczos steps with a
    noisy right-hand side, then apply the PETSc-style transform
    (a*lmin + b*lmax, c*lmin + d*lmax) with the reference's (0, 0.1, 0, 1.1)
    (elasticity.c:540: KSPChebyshevEstEigSet 0,0.1,0,1.1).

    The CG coefficients stay on the device until the loop ends; one read
    brings them to the host, where the Lanczos tridiagonal's eigenvalues
    are taken in float64. Returns (lam_min_bound, lam_max_bound) as floats.
    r0: the start vector (default eig_start_vector's); dot: the inner
    product, a 0-dim float64 tensor (the distributed driver passes its
    probe vector and its all-reduced dot).
    """
    a, bb, c, d = transform
    r = eig_start_vector(shape, dtype, diag_inv.device) if r0 is None else r0
    z = diag_inv * r
    p = z
    rz = dot(r, z)
    coefs = []
    for _ in range(iters):
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        r = r - alpha.to(dtype) * Ap
        z = diag_inv * r
        rz_new = dot(r, z)
        beta = rz_new / rz
        coefs += [alpha, beta]
        p = z + beta.to(dtype) * p
        rz = rz_new
    ab = np.asarray(torch.stack(coefs).tolist(),
                    dtype=np.float64).reshape(iters, 2)
    # Krylov breakdown: once r = 0 (the space is exhausted, e.g. a level
    # with fewer free DOFs than iters) the next coefficients are 0/0. The
    # Lanczos matrix of the steps before it is exact, so keep those. (The
    # JAX version takes the NaNs into eigvalsh and returns NaN bounds.)
    bad = ~np.isfinite(ab).all(axis=1) | (ab[:, 0] == 0)
    k = int(np.argmax(bad)) if bad.any() else iters
    if k == 0:
        # no step to keep: a level without free DOFs (p = 1 on one
        # element, every node on the boundary), where p.Ap = 0. JAX's
        # bounds, NaN: an AMG coarse solve never reads them, a Chebyshev
        # one turns them into a non-finite step, as in the JAX package
        return math.nan, math.nan
    alphas, betas = ab[:k, 0], ab[:k, 1]
    # Lanczos tridiagonal from CG coefficients
    diag = 1.0 / alphas
    diag[1:] += betas[:-1] / alphas[:-1]
    off = np.sqrt(np.abs(betas[:-1])) / alphas[:-1]
    eigs = np.linalg.eigvalsh(np.diag(diag) + np.diag(off, 1)
                              + np.diag(off, -1))
    lmin, lmax = float(eigs[0]), float(eigs[-1])
    return a * lmin + bb * lmax, c * lmin + d * lmax
