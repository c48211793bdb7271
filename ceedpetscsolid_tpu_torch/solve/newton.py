"""Newton solver with critical-point line search.
Port of ceedpetscsolid_tpu/solve/newton.py.

The SNES analog (reference elasticity.c:595-601, 636-673): Newton iterations
with the CP line search (secant steps on g(lambda) = F(x + lambda d) . d,
one by default as in SNESLINESEARCHCP) or the basic full step, both with
domain-error backtracking, driven by the load-increment continuation loop
of problem.py. The outer loop runs on the host; residuals, linear solves
and reductions run on the problem's device. Each iteration is the span
"newton/step", its line search with the domain backtracking
"newton/line_search" (utils/timing).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..utils.precise import norm2, dot2
from ..utils.timing import span


@dataclass
class NewtonOptions:
    """PETSc SNES-compatible defaults (see the JAX version for the
    derivation of the stagnation thresholds)."""

    rtol: float = 1e-8
    atol: float = 1e-50
    stol: float = 1e-8
    max_it: int = 50
    divtol: float = 1e4
    linesearch: str = "cp"      # 'cp' | 'basic'
    ls_max_it: int = 1          # SNESLineSearchCP default secant steps
    monitor: Callable | None = None
    # a stagnating iterate counts as converged only once it gained
    # stall_rtol relative to entry (f32 floors sit near 1e-6 relative)
    stall_rtol: float = 1e-5
    # a stagnating iterate whose step is tiny relative to the solution sits
    # at the attainable floor (used with NewtonPolicy.floor_atol)
    stall_stol: float = 1e-4
    # meaningful progress = a new best residual at least this much lower
    stall_decrease: float = 0.02
    max_stalls_floor: int = 2
    max_stalls_hard: int = 6
    # Eisenstat-Walker adaptive forcing (PETSc -snes_ksp_ew, choice 2)
    ew: bool = False
    ew_eta0: float = 0.3
    ew_eta_max: float = 0.9
    ew_gamma: float = 0.9
    ew_alpha: float = 1.6180339887498949      # (1+sqrt(5))/2


class NewtonResult(NamedTuple):
    u: torch.Tensor
    iters: int
    linear_iters: int
    rnorm: float
    converged: bool
    reason: str


class NewtonPolicy:
    """Host-side convergence policy (the SNESConvergedDefault role,
    reference elasticity.c:668-672), identical to the JAX version's.

    Call `check(rnorm, step, unorm)` after each Newton update; it returns
    a (converged, reason) pair once the iteration should stop, else None.
    floor_atol: absolute residual level known to be attainable-floor
    territory for this problem scale and dtype (the largest final rnorm of
    previously accepted increments).
    """

    def __init__(self, opts: NewtonOptions, rnorm0: float,
                 floor_atol: float = 0.0):
        self.opts = opts
        self.rnorm0 = rnorm0
        self.best = rnorm0
        self.floor_atol = floor_atol
        self.stalls = 0

    def _at_floor(self, rnorm: float) -> bool:
        return rnorm <= max(self.opts.stall_rtol * self.rnorm0,
                            2.0 * self.floor_atol)

    def check(self, rnorm: float, step: float | None = None,
              unorm: float | None = None):
        o = self.opts
        if not math.isfinite(rnorm) or rnorm > o.divtol * self.rnorm0:
            return (False, "diverged")
        if rnorm <= max(o.atol, o.rtol * self.rnorm0):
            return (True, "rtol")
        tiny = (step is not None and unorm is not None
                and step <= o.stall_stol * max(unorm, 1e-30))
        if step is not None and unorm is not None and \
                step <= o.stol * max(unorm, 1e-30):
            # a vanishing step means convergence only if the residual
            # dropped; a bailed linear solve also gives a near-zero step
            if self._at_floor(rnorm):
                return (True, "stol")
            return (False, "stalled (no step)")
        improved = rnorm < (1.0 - o.stall_decrease) * self.best
        self.best = min(self.best, rnorm)
        self.stalls = 0 if improved else self.stalls + 1
        if self.stalls >= o.max_stalls_floor and (
                rnorm <= o.stall_rtol * self.rnorm0
                or (tiny and self._at_floor(rnorm))):
            return (True, "stagnation (fp noise floor)")
        if self.stalls >= o.max_stalls_hard:
            return (False, "stalled")
        return None

    def finalize(self, rnorm: float):
        """Verdict for a loop that ran out of max_it."""
        if math.isfinite(rnorm) and self._at_floor(rnorm):
            return (True, "max_it (below stall floor)")
        return (False, "max_it")


def _backtrack(residual, u, d, lam):
    """Domain-error backtracking from the step length lam: a step that
    leaves the model's domain (hyperFS needs J > 0) gives a non-finite
    residual and is halved toward u, up to 12 times. Returns (u_new, G_new,
    stash_new, rnorm_new, |lam d|, |u_new|) with float norms."""
    for t in range(13):
        if t:
            lam *= 0.5
        u_new = u + lam * d
        G_new, stash = residual(u_new)
        rnorm, step, unorm = torch.stack(
            [norm2(G_new), norm2(lam * d), norm2(u_new)]).tolist()
        if math.isfinite(rnorm):
            break
    return u_new, G_new, stash, rnorm, step, unorm


def secant_step(residual, u, G, d) -> float:
    """Step length of the CP line search at its default of one secant step
    on g(l) = G(u + l d) . d from l = 1 (SNESLineSearchCP; reference
    elasticity.c:595-601), 1 outside (1e-8, 1e2): the JAX version's fused
    line search (problem.py:457-492), whose domain backtracking follows in
    _backtrack; one device sync for both dot products."""
    G1, _ = residual(u + d)
    g0, g1 = torch.stack([dot2(G, d), dot2(G1, d)]).tolist()
    lam = g0 / (g0 - g1) if g0 != g1 else math.nan
    return lam if math.isfinite(lam) and 1e-8 < lam < 1e2 else 1.0


def secant_search(residual, u, G, d, opts: NewtonOptions) -> float:
    """Step length of the CP line search with opts.ls_max_it secant steps on
    g(l) = G(u + l d) . d from l = 1, or 1 for the basic line search and
    for ls_max_it <= 0 (the JAX version's _line_search, newton.py:263-301).
    A trial step whose g is not finite is halved toward u, up to 12 times
    (0 when none is finite), and the secant restarts from l = 0; a secant
    step outside (1e-8, 1e2] gives 1."""
    if opts.linesearch == "basic" or opts.ls_max_it <= 0:
        return 1.0
    g0 = float(dot2(G, d))
    lam_old, g_old = 0.0, g0
    lam = 1.0
    for _ in range(opts.ls_max_it):
        Gl, _ = residual(u + lam * d)
        g = float(dot2(Gl, d))
        if not math.isfinite(g):
            for _ in range(12):
                lam *= 0.5
                Gl, _ = residual(u + lam * d)
                g = float(dot2(Gl, d))
                if math.isfinite(g):
                    break
            else:
                return 0.0
            lam_old, g_old = 0.0, g0
        denom = g - g_old
        if denom == 0.0 or not math.isfinite(denom):
            break
        lam_new = lam - g * (lam - lam_old) / denom
        lam_old, g_old = lam, g
        lam = lam_new
        if not math.isfinite(lam) or lam <= 1e-8 or lam > 1e2:
            return 1.0
    return lam


def newton_solve(
    residual: Callable,        # u -> (G(u), stash); BC-masked nonlinear residual
    linear_solve: Callable,    # (u, G, stash[, eta]) -> (d, ksp_iters): J d = -G
    u0: torch.Tensor,
    opts: NewtonOptions,
    floor_atol: float = 0.0,
) -> NewtonResult:
    """Newton iteration. `residual` must already include forcing and BCs."""
    u = u0
    G, stash = residual(u)
    rnorm0 = float(norm2(G))
    rnorm = rnorm0
    lin_total = 0
    if rnorm0 == 0.0:
        return NewtonResult(u, 0, 0, 0.0, True, "zero initial residual")
    if not math.isfinite(rnorm0):
        # the entry state is outside the constitutive domain (J <= 0):
        # report divergence so the load loop can sub-step
        return NewtonResult(u, 0, 0, rnorm0, False, "diverged")

    # the JAX version fuses the default line search into one device program
    # and runs every other one step by step; both paths are ported
    fused = opts.linesearch == "cp" and opts.ls_max_it == 1
    reason = "max_it"
    converged = False
    it = 0
    policy = NewtonPolicy(opts, rnorm0, floor_atol=floor_atol)
    ew_eta = opts.ew_eta0
    for it in range(1, opts.max_it + 1):
        with span("newton/step"):
            if opts.ew:
                d, ksp_its = linear_solve(u, G, stash, ew_eta)
            else:
                d, ksp_its = linear_solve(u, G, stash)
            lin_total += int(ksp_its)
            with span("newton/line_search"):
                lam = (secant_step(residual, u, G, d) if fused
                       else secant_search(residual, u, G, d, opts))
                u, G, stash, rnorm_new, step, unorm = _backtrack(residual, u,
                                                                 d, lam)
        if opts.monitor is not None:
            opts.monitor(it, rnorm_new)
        if opts.ew and math.isfinite(rnorm_new) and rnorm > 0:
            eta = opts.ew_gamma * (rnorm_new / rnorm) ** opts.ew_alpha
            safe = opts.ew_gamma * ew_eta ** opts.ew_alpha
            if safe > 0.1:
                eta = max(eta, safe)
            target = max(opts.atol, opts.rtol * rnorm0)
            eta = max(eta, 0.5 * target / max(rnorm_new, 1e-300))
            ew_eta = min(opts.ew_eta_max, eta)
        rnorm = rnorm_new
        verdict = policy.check(rnorm, step=step, unorm=unorm)
        if verdict is not None:
            converged, reason = verdict
            break
    else:
        converged, reason = policy.finalize(rnorm)
    return NewtonResult(u, it, lin_total, rnorm, converged, reason)
