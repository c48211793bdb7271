"""Distributed Newton driver on torch.distributed, one process per rank.
Port of ceedpetscsolid_tpu/parallel/driver.py.

Mirrors the serial solve path of problem.py with every operator
application distributed: each rank runs the fused element apply
(ops/fused_apply.py, the hand-written CUDA kernel on a GPU) on its own
subdomain's elements, as the reference runs one CeedOperator a rank
(src/matops.c:26-60), with the halo exchange of parallel/dist.py around
it. One Newton iteration: the BC-masked residual, CG preconditioned by
Jacobi or by the p-multigrid V-cycle (Chebyshev smoothers, the replicated
AMG or a Chebyshev coarse solve), one secant step of the critical-point
line search, domain backtracking, the update.

The halo overlaps compute as in the JAX package's split_rows: the ghost
exchange starts, the INTERIOR batch (elements whose nodes this rank owns,
`partition_space`'s interior-first order) runs on the owned block while it
is in flight, and the boundary batch runs once the ghosts arrived.

Preconditioner data (level diagonals, Chebyshev bounds) is built once per
Jacobian refresh (`pc_setup`, the KSPChebyshevEstEig cadence) and the AMG
coarse hierarchy by `refresh_amg`, whose p = 1 element matrices every rank
computes on its device and all ranks gather, so each assembles the same
matrix and runs the same native setup. Both record their stages in the
problem's StageLog (`log`): they run outside a Newton step, so the
synchronisation each stage ends with times nothing of the step.

The JAX package's slab spectral path on boxes (parallel/slab.py,
`SpectralLattice`) is a TPU layout and is not ported: `use_slab=True`
raises, and every mesh takes the generic halo. JAX's `accurate_matmuls`
has no counterpart: float32 contractions here run with TF32 off.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import fused_apply as fa
from ..ops.assembly import CSRAssembler, make_element_matrices
from ..ops.operator import element_diagonal
from ..solve.amg import AMGPreconditioner
from ..solve.cg import pcg
from ..solve.newton import NewtonOptions, NewtonPolicy
from ..utils.profile_solve import AMG_SCOPE
from ..utils.timing import StageLog, fine, span
from . import mg as dmg
from .dist import Comm, ddot, dnorm
from .partition import gather_owned_to_global, partition_space

# domain-error halvings of the line-search step (the JAX step's bt_cond)
MAX_HALVINGS = 8


def _split(tensors, k: int):
    """((t[:, :k] for t), (t[:, k:] for t)): the interior and boundary
    batches of element-indexed tensors, contiguous (None stays None)."""
    return tuple(tuple(None if t is None else t[:, sl].contiguous()
                       for t in tensors)
                 for sl in (slice(0, k), slice(k, None)))


@dataclass
class _Stash:
    """The gradu stash of one residual over this rank's elements, in
    element order ((9, nelem, Q3) tensors; None for a linear model), and
    its per-level batch splits, built once per Jacobian."""

    mu: torch.Tensor | None
    p: torch.Tensor | None
    splits: dict = field(default_factory=dict)

    def split(self, k: int):
        """((mu, p) interior, (mu, p) boundary) at the interior count k."""
        if k not in self.splits:
            self.splits[k] = _split((self.mu, self.p), k)
        return self.splits[k]


class DistributedProblem:
    """Distributes an ElasticityProblem over the ranks of a process group
    (default WORLD), on the problem's device.

    use_mg: p-multigrid-preconditioned CG (needs the problem configured
    with multigrid != 'none'); composite models (hyperFSIncomp) get the
    same distributed p-MG as single-operator ones. use_slab: None or False
    (the generic halo); True raises, the slab path is not ported.

    Vectors are this rank's owned blocks, (3, n_owned_max) tensors with
    zero padding (`to_owned`, `to_global`)."""

    def __init__(self, problem, group=None, use_mg: bool | None = None,
                 use_slab: bool | None = None):
        if use_slab:
            raise ValueError(
                "use_slab=True: the slab spectral path of the JAX package "
                "(ceedpetscsolid_tpu/parallel/slab.py, built on its TPU "
                "layout SpectralLattice) is not ported; use_slab=None or "
                "False takes the generic halo")
        prob = self.problem = problem
        self.use_slab, self.slab = use_slab, None
        self.device, self.dtype = prob.device, prob.dtype
        self.comm = Comm(group, prob.device)
        # refresh_amg's and pc_setup's stages: each phase's wall under its
        # name, its parts under "<phase>: <part>"
        self.log = StageLog(self.device)
        # the exit reason of the last newton_step's CG ("converged",
        # "max_it", "indefinite", "stalled", ...)
        self.cg_reason = None
        self.ndev, self.rank = self.comm.world, self.comm.rank
        nlev = len(prob.spaces)
        if use_mg is None:
            use_mg = prob.config.multigrid != "none" and nlev > 1
        self.use_mg = use_mg
        fes = prob.fine_space
        t0 = time.perf_counter()
        self.part = partition_space(fes.conn, fes.num_nodes, self.ndev)
        self.partition_seconds = {fes.degree: time.perf_counter() - t0}
        self.model, self.phys = prob.model, prob.phys
        self.composite = prob.composite
        self._pw = fa.PHYSICS[self.model.name]
        self._pwp = (fa.PHYSICS[self.model.pressure_name] if self.composite
                     else None)

        # qdata: this rank's elements in the partition's (interior-first)
        # order
        gids = self.part.elem_gid[self.rank]
        elem = torch.as_tensor(gids[gids >= 0], device=self.device)
        self.qdata = prob.qdata[:, elem].contiguous()
        self.qdata_p = (prob.qdata_p[:, elem].contiguous() if self.composite
                        else None)
        own = self._owned_np
        self.mask = own(prob.bc_mask.cpu().numpy(), torch.bool)
        self.F = own(prob.F.cpu().numpy())

        self.levels, coarse_s = dmg.build_dist_levels(
            prob, self.part, self.comm,
            levels=None if use_mg else [nlev - 1])
        self.partition_seconds.update(coarse_s)
        # each level's element diagonals (the pressure part's too); its
        # qdata split at its interior count is made at first use
        self._diag_e = [
            (element_diagonal(self.model.jacobian_qf, self.phys, lv.basis),
             element_diagonal(self.model.pressure_jacobian_qf, self.phys,
                              lv.pbasis) if self.composite else None)
            for lv in self.levels]
        self._qd = {}
        self._amg = None
        if use_mg:
            self._em_mu = make_element_matrices(
                self.model.jacobian_qf, self.phys, self.levels[0].basis,
                self.dtype)
            self._em_p = (make_element_matrices(
                self.model.pressure_jacobian_qf, self.phys,
                self.levels[0].pbasis, self.dtype)
                if self.composite else None)
        self._res_cache = None
        # fused-apply calls made by this rank's batches, per mode: on a
        # CUDA rank each is one kernel launch (fused_apply.COUNTS), which
        # a caller can hold equal to show no batch ran the plain version
        self.batch_applies = {"residual": 0, "jacobian": 0}

    # -- layout helpers ------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _owned_np(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        return dmg.owned_slice(self.part, self.rank, arr, dtype or self.dtype,
                               self.device)

    def _qdata_split(self, k: int):
        if k not in self._qd:
            self._qd[k] = _split((self.qdata, self.qdata_p), k)
        return self._qd[k]

    def _level_part(self, l: int):
        return self.levels[l].part

    def _inv_mult(self, l: int):
        """Owned inverse multiplicity of level l (None on the coarsest)."""
        return self.levels[l].inv_mult

    def to_owned(self, u_global) -> torch.Tensor:
        """(3, num_nodes) global array (numpy or tensor) -> this rank's
        (3, n_owned_max) block in the problem's dtype, on its device."""
        if isinstance(u_global, torch.Tensor):
            u_global = u_global.detach().cpu().numpy()
        return self._owned_np(np.asarray(u_global))

    def to_global(self, owned: torch.Tensor) -> np.ndarray:
        """This rank's owned block -> the (3, num_nodes) global array, on
        every rank (one all-gather)."""
        blocks = self.comm.all_gather(owned).cpu().numpy()
        return gather_owned_to_global(self.part, blocks)

    def halo_stats(self) -> dict:
        return self.part.halo_stats()

    def _bc_owned(self, load: float) -> torch.Tensor:
        return self.to_owned(self.problem.bc_values(load))

    # -- the distributed operators -------------------------------------------
    def _split_apply(self, lv, owned: torch.Tensor, batch):
        """Halo-overlapped element apply (ApplyLocalCeedOp analog,
        matops.c:26-60): the ghost exchange starts, the interior batch
        runs on the owned block meanwhile, the boundary batch on the local
        vector once the ghosts arrived; then the owner-sum. batch(b, src,
        conn) -> (ve, aux) for batch b (0 interior, 1 boundary); returns
        (owned result, [aux of each batch run])."""
        ra = lv.ra
        started = ra.g2l_start(owned)
        ve_i = aux_i = aux_b = None
        if ra.conn_int.shape[0]:
            ve_i, aux_i = batch(0, owned, ra.conn_int)
        local = ra.g2l_finish(started)
        if ra.conn_bnd.shape[0]:
            ve_b, aux_b = batch(1, local, ra.conn_bnd)
            acc = ra.restr_bnd.scatter_add(ve_b)
        else:
            acc = local.new_zeros((3, ra.n_local))
        out = ra.l2g_add(acc)
        if ve_i is not None:
            out = out + ra.restr_int.scatter_add(ve_i)
        return out, (aux_i, aux_b)

    def _raw_residual(self, u_in: torch.Tensor):
        """Unmasked residual (owned) and the stash, both operators of a
        composite model on every batch."""
        lv = self.levels[-1]
        k = lv.ra.n_elem_int
        qd = self._qdata_split(k)

        def batch(b, src, conn):
            ve, st = fa.residual(src, conn, qd[b][0], lv.basis, self.phys,
                                 self._pw)
            stp = None
            self.batch_applies["residual"] += 1 + self.composite
            if self.composite:
                vep, stp = fa.residual(src, conn, qd[b][1], lv.pbasis,
                                       self.phys, self._pwp)
                ve = ve + vep
            return ve, (st, stp)

        r, (ai, ab) = self._split_apply(lv, u_in, batch)
        parts = [a for a in (ai, ab) if a is not None]

        def cat(i):
            ts = [a[i] for a in parts]
            if ts[0] is None:
                return None
            return ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)

        stash = _Stash(cat(0), cat(1))
        # the fine level's split is the batches' own stashes
        none = (None, None)
        stash.splits[k] = (ai or none, ab or none)
        return r, stash

    def _residual(self, u, bc, F):
        """G(u) = R(u with BCs inserted) - F, zero at constrained DOFs, and
        the stash."""
        r, stash = self._raw_residual(torch.where(self.mask, bc, u))
        return torch.where(self.mask, 0.0, r - F), stash

    def _entry_residual(self, u, load):
        """(G, stash, owned BC values) at (u, load), kept for the last
        (u, load): refresh_amg, pc_setup and newton_step all evaluate it at
        the same state. The key is the tensor object u, which this class
        never changes in place."""
        c = self._res_cache
        if c is not None and c[0] is u and c[1] == load:
            return c[2], c[3], c[4]
        bc = self._bc_owned(load)
        G, stash = self._residual(u, bc, self.F * load)
        self._res_cache = (u, load, G, stash, bc)
        return G, stash, bc

    def _level_apply(self, l: int, stash: _Stash):
        """BC-masked J_l v at the fine quadrature (both operators of a
        composite model)."""
        lv = self.levels[l]
        k = lv.ra.n_elem_int
        qd, st = self._qdata_split(k), stash.split(k)

        def batch(b, src, conn):
            ve = fa.jacobian(src, conn, qd[b][0], st[b][0], lv.basis,
                             self.phys, self._pw)
            self.batch_applies["jacobian"] += 1 + self.composite
            if self.composite:
                ve = ve + fa.jacobian(src, conn, qd[b][1], st[b][1],
                                      lv.pbasis, self.phys, self._pwp)
            return ve, None

        def A(v):
            jv, _ = self._split_apply(lv, torch.where(lv.mask, 0.0, v), batch)
            return torch.where(lv.mask, 0.0, jv)

        return A

    def _level_diag(self, l: int, stash: _Stash) -> torch.Tensor:
        lv = self.levels[l]
        mu, p = self._diag_e[l]
        d = mu(self.qdata, stash.mu)
        if self.composite:
            d = d + p(self.qdata_p, stash.p)
        diag = lv.ra.l2g_add(lv.ra.scatter_elements(d))
        diag = torch.where(lv.mask, 1.0, diag)
        return torch.where(diag == 0.0, 1.0, diag)

    # -- entry points -------------------------------------------------------
    def residual_apply(self, u_owned, load_increment: float = 1.0):
        """The BC-inserted nonlinear residual on the owned block: the
        distributed counterpart of the serial fine apply."""
        bc = self._bc_owned(load_increment)
        G, _ = self._residual(u_owned, bc, self.F * load_increment)
        return G

    def refresh_amg(self, u_owned, load: float):
        """FormJacobian analog (misc.c:151-183): each rank computes its
        elements' p = 1 matrices from its stash on its device; every rank
        gathers all of them, takes them in the global element order and
        reduces them into the CSR values on its device as the serial
        refresh_amg does; the float64 values come to the host, where every
        rank runs the same native setup, so the coarse hierarchy is
        replicated as in the JAX package. A NaN stash raises
        FloatingPointError (the AMG's coarse matrix). Its stages go to
        `log`: the residual and stash, element matrices, all_gather, CSR
        pattern (the first call only), CSR reduce, d2h, native setup,
        extract and upload."""
        with self.log.stage("refresh_amg"):
            return self._refresh_amg(u_owned, load)

    def _refresh_amg(self, u_owned, load: float):
        prob, stage = self.problem, self.log.stage
        with stage("refresh_amg: residual and stash"):
            _, stash, _ = self._entry_residual(u_owned, load)
        with stage("refresh_amg: element matrices"):
            em = self._em_mu(self.qdata, stash.mu)
            if self.composite:
                em = em + self._em_p(self.qdata_p, stash.p)
            nd = em.shape[-1]
            pad = em.new_zeros((self.part.nelem_max, nd, nd))
            pad[: em.shape[0]] = em
        with stage("refresh_amg: all_gather"):
            allm = self.comm.all_gather(pad).reshape(-1, nd, nd)
        if self._amg is None:
            with stage("refresh_amg: CSR pattern"):
                # position of each global element among the gathered
                # blocks
                gids = self.part.elem_gid.reshape(-1)
                pos = np.nonzero(gids >= 0)[0]
                self._elem_order = torch.as_tensor(
                    pos[np.argsort(gids[pos])], device=self.device)
                # the serial problem's assembler when it has one: the
                # same p = 1 pattern and BC masks
                self._assembler0 = getattr(prob, "_assembler0", None)
                if self._assembler0 is None:
                    space0 = prob.spaces[0]
                    self._assembler0 = CSRAssembler(
                        space0.conn, space0.num_nodes,
                        prob._level_mask(space0).cpu().numpy(),
                        device=self.device)
                self._amg = AMGPreconditioner(self.dtype, self.device)
        with stage("refresh_amg: CSR reduce"):
            vals = self._assembler0.assemble_values(allm[self._elem_order])
        with stage("refresh_amg: d2h"):
            vals = vals.to(torch.float64).cpu().numpy()
        # the host CSR counts with the native setup; the upload ends
        # synchronised (AMGPreconditioner.upload)
        with span("refresh_amg: native setup", log=self.log):
            self._amg.build(self._assembler0.from_values(vals))
        with span("refresh_amg: extract and upload", log=self.log):
            self._amg.upload()
        return self._amg.data

    def pc_setup(self, u_owned, load_increment: float):
        """Preconditioner refresh (level inverse diagonals and, for p-MG,
        Chebyshev bounds), run once per Jacobian like the serial
        _pc_setup. Jacobi: (1 / diag,); p-MG: (dinvs, bounds). Its stages
        go to `log`: the residual and stash, level diagonals, and
        "eigenvalue estimate p<degree>" a level."""
        with self.log.stage("pc_setup"):
            return self._pc_setup(u_owned, load_increment)

    def _pc_setup(self, u_owned, load_increment: float):
        stage = self.log.stage
        with stage("pc_setup: residual and stash"):
            _, stash, _ = self._entry_residual(u_owned, load_increment)
        with stage("pc_setup: level diagonals"):
            dinvs = [1.0 / self._level_diag(l, stash)
                     for l in range(len(self.levels) if self.use_mg else 1)]
        if not self.use_mg:
            return tuple(dinvs)
        bounds = []
        for l, lv in enumerate(self.levels):
            valid = ~lv.mask & lv.ra.owned_valid
            deg = self.problem.level_degrees[l]
            with stage(f"pc_setup: eigenvalue estimate p{deg}"):
                bounds.append(dmg.estimate_eigs_dist(
                    self._level_apply(l, stash), dinvs[l], valid, self.comm))
        return tuple(dinvs), tuple(bounds)

    def _vcycle(self, stash: _Stash, pc, amg_data):
        cfg = self.problem.config
        dinvs, bounds = pc
        lv = self.levels
        nlev = len(lv)
        A = [self._level_apply(l, stash) for l in range(nlev)]

        def coarse_solve(b0):
            if amg_data is None:
                return dmg.chebyshev_dist(A[0], b0, dinvs[0], *bounds[0], 30)
            # a span under the profiler (utils/profile_solve.step_split)
            with fine(AMG_SCOPE):
                g = dmg.owned_to_replicated_global(b0, lv[0], self.comm)
                xf = self._amg.apply(g.T.reshape(-1), amg_data)
                out = dmg.replicated_global_to_owned(xf.reshape(-1, 3).T,
                                                     lv[0])
                return torch.where(lv[0].mask, 0.0, out)

        def vcycle(bf):
            bs, xs = [None] * nlev, [None] * nlev
            bs[-1] = bf
            for l in range(nlev - 1, 0, -1):
                xs[l] = dmg.chebyshev_dist(A[l], bs[l], dinvs[l], *bounds[l],
                                           cfg.smooth_its)
                r = bs[l] - A[l](xs[l])
                bs[l - 1] = torch.where(lv[l - 1].mask, 0.0,
                                        dmg.restrict(r, lv[l - 1], lv[l]))
            xs[0] = coarse_solve(bs[0])
            for l in range(1, nlev):
                x = xs[l] + torch.where(lv[l].mask, 0.0,
                                        dmg.prolong(xs[l - 1], lv[l - 1],
                                                    lv[l]))
                r = bs[l] - A[l](x)
                xs[l] = x + dmg.chebyshev_dist(A[l], r, dinvs[l], *bounds[l],
                                               cfg.smooth_its)
            return xs[-1]

        return vcycle, A[-1]

    def newton_step(self, u_owned, load_increment: float, amg_data=None,
                    pc=None):
        """One Newton iteration (JAX driver.py:510-667): the residual, PCG
        with Jacobi or the V-cycle (windowed stagnation guard, indefinite
        exit), one secant step of the CP line search clamped to
        (1e-8, 1e2), up to MAX_HALVINGS halvings while the residual is not
        finite. Returns (u_new, rnorm_in, rnorm, iters, step_norm, unorm),
        the norms as floats."""
        cfg = self.problem.config
        comm = self.comm
        load = load_increment
        if pc is None:
            pc = self.pc_setup(u_owned, load)
        G, stash, bc = self._entry_residual(u_owned, load)
        F = self.F * load

        def residual(uo):
            return self._residual(uo, bc, F)

        if self.use_mg:
            M, jac = self._vcycle(stash, pc, amg_data)
        else:
            (dinv,) = pc
            jac = self._level_apply(0, stash)

            def M(r):
                return dinv * r
        res = pcg(jac, -G, M_inv=M, rtol=cfg.ksp_rtol or 1e-10,
                  maxiter=min(cfg.ksp_max_it, 10_000), stall_its=60,
                  dot=lambda a, b: ddot(a, b, comm))
        d = res.x
        self.cg_reason = res.reason

        # critical-point line search: one secant step
        G1, _ = residual(u_owned + d)
        g0, g1 = torch.stack([ddot(G, d, comm), ddot(G1, d, comm)]).tolist()
        lam = g0 / (g0 - g1) if g0 != g1 else math.nan
        if not (math.isfinite(lam) and 1e-8 < lam < 1e2):
            lam = 1.0
        # domain-error backtracking (hyperFS needs J > 0)
        for t in range(MAX_HALVINGS + 1):
            if t:
                lam *= 0.5
            G_new, _ = residual(u_owned + lam * d)
            rnorm = float(dnorm(G_new, comm))
            if math.isfinite(rnorm):
                break
        u_new = u_owned + lam * d
        rnorm_in, step, unorm = torch.stack(
            [dnorm(G, comm), dnorm(d, comm), dnorm(u_new, comm)]).tolist()
        return u_new, rnorm_in, rnorm, res.iters, abs(lam) * step, unorm

    def solve(self, num_increments=None, max_newton=50, rtol=1e-8):
        """Load-continuation solve; returns (u_global numpy (3, N), info).
        The convergence policy is the serial driver's NewtonPolicy; rtol
        1e-8 is set for float64 (a float32 run passes a looser one).
        info also carries the wall seconds of each Newton step
        ("step_seconds"), the part of each spent in the AMG refresh and
        pc_setup ("pc_seconds"), both synchronised, and the seconds in
        the exchanges ("exchange_seconds", per kind: Comm.seconds, the
        host's under gloo, the device's under NCCL) and in the stages of
        refresh_amg and pc_setup ("stage_seconds": the `log`'s)."""
        cfg = self.problem.config
        n_inc = num_increments or cfg.num_increments
        u = self.to_owned(np.zeros((3, self.problem.fine_space.num_nodes)))
        total_ksp = total_newton = 0
        rnorm = None
        amg_data = pc = None
        converged, reason = True, ""
        floor_atol = 0.0
        opts = NewtonOptions(rtol=rtol, max_it=max_newton)
        step_s, pc_s = [], []
        ex0 = self.comm.seconds()
        st0 = self.log.seconds()
        for inc in range(1, n_inc + 1):
            load = inc / n_inc
            policy = None
            converged, reason = False, "max_it"
            pc_lag = max(getattr(cfg, "pc_lag", 1), 1)
            for k in range(max_newton):
                t0 = time.perf_counter()
                refresh = self.model.nonlinear and (k % pc_lag == 0)
                if self.use_mg and (refresh or amg_data is None):
                    try:
                        amg_data = self.refresh_amg(u, load)
                    except FloatingPointError:
                        # BC jump pushed the state outside the constitutive
                        # domain (NaN stash): divergence, as the serial loop
                        converged, reason = False, "diverged"
                        rnorm = float("nan")
                        break
                if refresh or pc is None:
                    pc = self.pc_setup(u, load)
                self._sync()
                pc_s.append(time.perf_counter() - t0)
                u, rnorm_in, rnorm, iters, step_norm, unorm = \
                    self.newton_step(u, load, amg_data=amg_data, pc=pc)
                self._sync()
                step_s.append(time.perf_counter() - t0)
                total_ksp += int(iters)
                total_newton += 1
                if policy is None:
                    policy = NewtonPolicy(opts, max(rnorm_in, 1e-300),
                                          floor_atol=floor_atol)
                verdict = policy.check(rnorm, step=step_norm, unorm=unorm)
                if verdict is not None:
                    converged, reason = verdict
                    break
            else:
                if policy is not None:
                    converged, reason = policy.finalize(rnorm)
            if converged:
                floor_atol = max(floor_atol, rnorm)
            if not converged and reason == "diverged":
                break  # elasticity.c:668-672
        self._res_cache = None
        u_np = self.to_global(u)
        prob = self.problem
        bc_vals = prob.bcs.values(prob._coords, 1.0).T
        u_np = np.where(prob.bc_mask.cpu().numpy(), bc_vals, u_np)
        return u_np, {
            "newton_iters": total_newton,
            "ksp_iters": total_ksp,
            "rnorm": float(rnorm),
            "converged": converged,
            "reason": reason,
            "step_seconds": step_s,
            "pc_seconds": pc_s,
            "exchange_seconds": {k: v - ex0[k]
                                 for k, v in self.comm.seconds().items()},
            "stage_seconds": {k: v - st0.get(k, 0.0)
                              for k, v in self.log.seconds().items()},
        }
