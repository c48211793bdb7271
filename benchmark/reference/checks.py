"""The comparisons that decide `correct`, and the plain solvers that the
reference and its control run.

  residual_ratio  a converged displacement judged by what it says:
                  ||G(u)|| / ||G(u0)|| in float64, G the -test problem's
                  residual at the free DOFs, u0 the boundary values with
                  zero inside: the share of the start's residual that the
                  answer leaves
  linear_residual a linear solve's answer judged by what it says:
                  ||b - J x|| / ||b|| in float64, J the masked Jacobian
  newton, cg      the reference's own Newton solve and Jacobi CG: the
                  control's solves in the program's place
"""

from __future__ import annotations

import math

import torch

from .fem import HyperFSReference


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v.double()))


class SolveJudge:
    """residual_ratio for one reference operator (its forcing and start
    residual computed once)."""

    def __init__(self, ref: HyperFSReference):
        self.ref = ref
        self.F = ref.forcing()
        u0 = torch.where(ref.mask, ref.bc_values(), 0.0)
        self.g0 = _norm(self._G(u0))

    def _G(self, u):
        r, _ = self.ref.residual(u)
        return torch.where(self.ref.mask, 0.0, r - self.F)

    def residual_ratio(self, u) -> float:
        u = torch.as_tensor(u).to(self.ref.device, self.ref.dtype)
        return _norm(self._G(u)) / self.g0


def dot(a, b):
    """a . b summed in float64 (a 0-dim float64 tensor): CG's scalars at
    float64 grade whatever the vectors' precision."""
    return torch.dot(a.reshape(-1).double(), b.reshape(-1).double())


def cg(apply, b, dinv, rtol: float, maxiter: int = 10_000,
       stall_its: int = 60):
    """Jacobi-preconditioned CG from x = 0, vectors in b's precision and
    scalars in float64, until the natural norm falls by rtol, maxiter, or
    it has not fallen 5% below its anchor for stall_its iterations (the
    program's CG stops by the same rules). -> (x, its)."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z
    rz = dot(r, z)
    n0 = math.sqrt(abs(float(rz)))
    anchor, since, it = n0, 0, 0
    while it < maxiter:
        Ap = apply(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
        rn = math.sqrt(abs(float(rz)))
        if rn <= rtol * n0:
            break
        anchor, since = (rn, 0) if rn < 0.95 * anchor else (anchor,
                                                            since + 1)
        if since >= stall_its:
            break
    return x, it


def linear_residual(ref: HyperFSReference, stash, b, x) -> float:
    """||b - J x|| / ||b||: the masked Jacobian at the stash, in the
    reference's precision."""
    b = torch.as_tensor(b).to(ref.device, ref.dtype)
    x = torch.as_tensor(x).to(ref.device, ref.dtype)
    return _norm(b - ref.jacobian(x, stash)) / _norm(b)


def newton(ref: HyperFSReference, rtol: float, ksp_rtol: float,
           max_it: int = 6, ksp_max_it: int = 4000) -> torch.Tensor:
    """The -test problem solved by Newton with Jacobi CG from the boundary
    values with zero inside, in the reference's precision; stops at
    rtol of the start's residual norm or after max_it steps."""
    F = ref.forcing()
    u = torch.where(ref.mask, ref.bc_values(), 0.0)
    g0 = None
    for k in range(max_it + 1):
        r, stash = ref.residual(u)
        G = torch.where(ref.mask, 0.0, r - F)
        gn = _norm(G)
        g0 = gn if g0 is None else g0
        if gn <= rtol * g0 or k == max_it:
            break
        dinv = 1.0 / ref.diagonal(stash)
        d, _its = cg(lambda v: ref.jacobian(v, stash), -G, dinv,
                     rtol=ksp_rtol, maxiter=ksp_max_it)
        u = u + d
    return u
