"""Problem orchestration: the framework's `main` (reference elasticity.c:45-924).
Port of ceedpetscsolid_tpu/problem.py for `multigrid="none"`.

Wires box mesh -> FE space -> operators -> BCs -> forcing -> Newton with
Jacobi-preconditioned CG, and exposes solve / postprocessing entry points.
Every residual and every CG matvec goes through the fused element apply
(ops/fused_apply.py), which on a CUDA device is the hand-written kernel.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .mesh.box import box_mesh
from .mesh.fespace import FESpace, build_fespace
from .models import Physics, get_model, mms
from .models.boundary import BoundaryConditions
from .models.forcing import assemble_forcing
from .ops.operator import OperatorFactory
from .solve.cg import pcg
from .solve.newton import NewtonOptions, NewtonResult, newton_solve
from .utils.timing import StageLog, sync

# failed-increment retries with a halved load delta (the reference breaks
# the continuation loop on the first divergence instead)
SUBSTEP_RETRIES = 4


def select_device(device=None) -> torch.device:
    """Resolve the compute device: the given one, else CUDA when available,
    else the CPU. Also turns TF32 off: a TF32 contraction keeps ~3 decimal
    digits, the same hazard that made single-pass bf16 residuals 18x noise
    on the TPU (ceedpetscsolid_tpu/utils/precise.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def default_dtype(device: torch.device) -> torch.dtype:
    """float64 on the CPU (parity path), float32 on CUDA (as the JAX
    package runs float32 on the TPU)."""
    return torch.float64 if device.type == "cpu" else torch.float32


@dataclass
class Config:
    """CLI-equivalent options (reference src/cloptions.c:26-285).

    Options the port does not implement yet raise NotImplementedError
    naming the option; none is silently ignored."""

    problem: str = "linElas"
    degree: int = 3
    qextra: int = 0
    nu: float = 0.3
    E: float = 1.0
    mesh_file: str | None = None
    box_faces: Sequence[int] = (3, 3, 3)
    box_lower: Sequence[float] = (0.0, 0.0, 0.0)
    box_upper: Sequence[float] = (1.0, 1.0, 1.0)
    forcing: str = "none"                       # none | constant | mms
    forcing_vec: Sequence[float] = (0.0, -1.0, 0.0)
    bc_clamp: Sequence[int] = ()
    bc_clamp_translate: dict = field(default_factory=dict)   # face -> (tx,ty,tz)
    bc_clamp_rotate: dict = field(default_factory=dict)      # face -> (kx,ky,kz,theta/pi)
    num_increments: int | None = None           # default 1 (linear) else 10
    multigrid: str = "logarithmic"              # only "none" is ported
    nu_smoother: float = 0.0
    test_mode: bool = False
    # units (cloptions.c:237-282)
    units_meter: float = 1.0
    units_second: float = 1.0
    units_kilogram: float = 1.0
    # solver knobs
    ksp_rtol: float = 1e-10
    ksp_max_it: int = 10_000
    ksp_monitor: bool = False                   # -ksp_monitor
    newton: NewtonOptions = field(default_factory=NewtonOptions)
    # None: CUDA when available, else the CPU; dtype None: per default_dtype
    device: torch.device | str | None = None
    dtype: torch.dtype | None = None

    def __post_init__(self):
        if self.test_mode:
            self.forcing = "mms"                # cloptions.c:185-187
        if self.num_increments is None:
            self.num_increments = 1 if self.problem == "linElas" else 10
        if self.problem in ("hyperFS", "hyperFSIncomp") and self.forcing == "constant":
            raise ValueError(
                "Cannot use constant forcing and finite strain formulation"
            )  # cloptions.c:89-93
        get_model(self.problem)                 # unported models raise
        if self.multigrid != "none":
            raise NotImplementedError(
                f"-multigrid {self.multigrid}: p-multigrid and AMG are not "
                "ported to ceedpetscsolid_tpu_torch yet; use -multigrid none")
        if self.mesh_file:
            raise NotImplementedError(
                f"-mesh {self.mesh_file}: Exodus-II meshes are not ported to "
                "ceedpetscsolid_tpu_torch yet (box meshes only)")
        self.device = select_device(self.device)
        if self.dtype is None:
            self.dtype = default_dtype(self.device)
        if self.qextra > 0 and self.device.type == "cuda":
            raise NotImplementedError(
                f"-qextra {self.qextra}: the CUDA fused apply is instantiated "
                "for Q = P only (qextra = 0)")

    @property
    def pascal(self) -> float:
        return self.units_kilogram / (self.units_meter * self.units_second**2)


class ElasticityProblem:
    """Owns mesh, space, operators, BCs, forcing, and the solve loop."""

    def __init__(self, config: Config, mesh=None):
        self.config = config
        self.device = config.device
        self.dtype = config.dtype
        self.log = StageLog(self.device)
        t0 = time.perf_counter()

        # --- mesh ("DM and Vector Setup" stage, elasticity.c:128-131) ----
        with self.log.stage("DM and Vector Setup"):
            if mesh is None:
                mesh = box_mesh(config.box_faces, config.box_lower,
                                config.box_upper)
            self.mesh = mesh
            self.fine_space: FESpace = build_fespace(mesh, config.degree)

        # --- operators ("Operator Setup", elasticity.c:230-233) ----------
        with self.log.stage("Operator Setup"):
            fes = self.fine_space
            self.factory = OperatorFactory(fes, qextra=config.qextra,
                                           dtype=self.dtype, device=self.device)
            self.qdata = self.factory.compute_qdata()
            self.model = get_model(config.problem)
            self.phys = Physics(nu=config.nu, E=config.E * config.pascal)
            # smoother physics for the diagonal (-nu_smoother, matops.c:215-232)
            diag_phys = (Physics(nu=config.nu_smoother,
                                 E=config.E * config.pascal)
                         if config.nu_smoother else self.phys)

            # --- boundary conditions --------------------------------------
            self.bcs = BoundaryConditions(num_nodes=fes.num_nodes)
            if config.test_mode or config.forcing == "mms":
                # MMS BCs on the whole boundary (setupdm.c:160-180)
                self.bcs.add_mms(fes.all_boundary_nodes())
            else:
                for face in config.bc_clamp:
                    cmax = np.zeros(7)
                    cmax[:3] = config.bc_clamp_translate.get(face, (0, 0, 0))
                    rot = np.asarray(config.bc_clamp_rotate.get(face, (0, 0, 0, 0)),
                                     dtype=np.float64)
                    norm = float(np.linalg.norm(rot[:3]))
                    if abs(norm) < 1e-16:
                        norm = 1.0
                    cmax[3:6] = rot[:3] / norm        # cloptions.c:124-131
                    cmax[6] = rot[3]
                    self.bcs.add_clamp(fes.face_set_nodes(face), cmax)
            # component-major (3, nnodes) layout throughout the solver
            self.bc_mask = torch.as_tensor(
                np.ascontiguousarray(self.bcs.mask().T), device=self.device)
            self._coords = fes.coords

            # --- forcing (zero at constrained DOFs: not solved for) -------
            F = assemble_forcing(self.factory, self.qdata, config.forcing,
                                 phys=self.phys, forcing_vec=config.forcing_vec)
            self.F = torch.where(self.bc_mask, 0.0, F)

            self._res = self.factory.make_residual_structured(self.phys)
            self._jac = self.factory.make_jacobian_structured(self.phys)
            self._energy_fn = self.factory.make_energy(self.model.energy_qf,
                                                       self.phys)
            self._diag_fn = self.factory.make_diagonal(self.model.jacobian_qf,
                                                       diag_phys)
        self.setup_time = time.perf_counter() - t0
        self._pc_time = 0.0

    # ------------------------------------------------------------------
    def bc_values(self, load_increment: float) -> torch.Tensor:
        v = self.bcs.values(self._coords, load_increment)
        return torch.as_tensor(np.ascontiguousarray(v.T), dtype=self.dtype,
                               device=self.device)       # (3, nnodes)

    def insert_bc(self, u: torch.Tensor, bc_vals: torch.Tensor) -> torch.Tensor:
        """DMPlexInsertBoundaryValues analog (matops.c:70-73)."""
        return torch.where(self.bc_mask, bc_vals, u)

    def _nonlinear_residual(self, u, bc_vals, F):
        """G(u) = R(u with BCs inserted) - F, zeroed at constrained DOFs
        (FormResidual_Ceed, matops.c:63-79). Returns (G, stash)."""
        r, stash = self._res(self.insert_bc(u, bc_vals), self.qdata)
        return torch.where(self.bc_mask, 0.0, r - F), stash

    def _jacobian_action(self, v, stash):
        """Zero-BC linearized action (ApplyJacobian_Ceed, matops.c:98-112)."""
        jv = self._jac(torch.where(self.bc_mask, 0.0, v), self.qdata, stash)
        return torch.where(self.bc_mask, 0.0, jv)

    def _jacobi_setup(self, stash) -> torch.Tensor:
        """Inverse operator diagonal (1 at constrained DOFs), refreshed per
        Jacobian like the reference's per-FormJacobian PC setup."""
        d = torch.where(self.bc_mask, 1.0, self._diag_fn(self.qdata, stash))
        return 1.0 / d

    def _linear_solve(self, G, stash, rtol=None):
        """Jacobi CG (elasticity.c:515-518) for J d = -G."""
        cfg = self.config
        t0 = time.perf_counter()
        diag_inv = self._jacobi_setup(stash)
        sync(self.device)
        self._pc_time += time.perf_counter() - t0
        res = pcg(lambda v: self._jacobian_action(v, stash), -G,
                  M_inv=lambda r: diag_inv * r,
                  rtol=cfg.ksp_rtol if rtol is None else rtol,
                  maxiter=cfg.ksp_max_it, monitor=cfg.ksp_monitor)
        return res.x, res.iters

    # ------------------------------------------------------------------
    def solve(self, monitor=None) -> "SolveInfo":
        """Load-increment continuation loop (elasticity.c:636-673)."""
        with self.log.stage("SNES Solve"):
            return self._solve_impl(monitor)

    def _solve_impl(self, monitor) -> "SolveInfo":
        cfg = self.config
        N = self.fine_space.num_nodes
        u = torch.zeros((3, N), dtype=self.dtype, device=self.device)
        total_snes = total_ksp = 0
        rnorm = 0.0
        self._pc_time = 0.0
        t0 = time.perf_counter()
        last = None
        load_done = 0.0
        floor_atol = 0.0

        def run_newton(load, u0):
            bc_vals = self.bc_values(load)
            F = self.F * load

            def residual(uu):
                return self._nonlinear_residual(uu, bc_vals, F)

            def linear_solve(uu, G, stash, eta=None):
                # Eisenstat-Walker forcing: never tighter than ksp_rtol
                rtol = None if eta is None else max(cfg.ksp_rtol, eta)
                return self._linear_solve(G, stash, rtol=rtol)

            return newton_solve(residual, linear_solve, u0, cfg.newton,
                                floor_atol=floor_atol)

        for inc in range(1, cfg.num_increments + 1):
            target = inc / cfg.num_increments
            # adaptive sub-stepping: a failed increment retries from the
            # last converged state with a halved load delta (the reference
            # breaks the continuation instead, elasticity.c:668-672)
            delta = target - load_done
            fails = 0
            while load_done < target - 1e-12:
                load = min(target, load_done + delta)
                res: NewtonResult = run_newton(load, u)
                total_snes += res.iters
                total_ksp += res.linear_iters
                rnorm = res.rnorm
                last = res
                if monitor is not None:
                    monitor(inc, load, res)
                if res.converged:
                    u = res.u
                    load_done = load
                    # attainable absolute floor observed so far
                    floor_atol = max(floor_atol, res.rnorm)
                else:
                    fails += 1
                    delta *= 0.5
                    if fails > SUBSTEP_RETRIES:
                        break
            if load_done < target - 1e-12:
                break  # elasticity.c:668-672 (after sub-step retries)
        sync(self.device)
        solve_time = time.perf_counter() - t0
        u_out = self.insert_bc(u, self.bc_values(max(load_done, 1e-30)))
        return SolveInfo(
            u=u_out,
            snes_iters=total_snes,
            ksp_iters=total_ksp,
            rnorm=rnorm,
            converged=bool(last.converged) if last else True,
            reason=last.reason if last else "",
            solve_time=solve_time,
            dofs=3 * N,
            pc_time=self._pc_time,
        )

    # ------------------------------------------------------------------
    # Postprocessing
    # ------------------------------------------------------------------
    def mms_error(self, u: torch.Tensor) -> float:
        """Relative L2 error vs the MMS true solution over the whole vector,
        boundary DOFs included (elasticity.c:800-804), in float64. `u` must
        carry the inserted boundary values (SolveInfo.u does)."""
        xyz = torch.as_tensor(self._coords, dtype=torch.float64,
                              device=self.device)
        u_star = mms.true_solution(xyz).T
        return float(torch.linalg.norm(u.to(torch.float64) - u_star)
                     / torch.linalg.norm(u_star))

    def strain_energy(self, u: torch.Tensor) -> float:
        """Total strain energy (matops.c:247-296), summed in float64."""
        return float(self._energy_fn(u))


@dataclass
class SolveInfo:
    u: torch.Tensor
    snes_iters: int
    ksp_iters: int
    rnorm: float
    converged: bool
    reason: str
    solve_time: float
    dofs: int
    pc_time: float = 0.0        # Jacobi diagonal builds, inside solve_time

    @property
    def mdofs_per_sec(self) -> float:
        """1e-6 * dofs * ksp_iters / time (elasticity.c:763-764)."""
        if self.solve_time == 0:
            return 0.0
        return 1e-6 * self.dofs * self.ksp_iters / self.solve_time
