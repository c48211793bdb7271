"""Problem orchestration: the framework's `main` (reference elasticity.c:45-924).
Port of ceedpetscsolid_tpu/problem.py for the four models on box meshes and
unstructured Exodus-II hex meshes.

Wires mesh (a box, or an Exodus-II file reordered for locality) -> FE
spaces (one per p-multigrid level) -> operators -> BCs -> forcing -> Newton
with CG preconditioned by Jacobi
(`multigrid="none"`), by the p-multigrid V-cycle with Chebyshev-Jacobi
smoothers and the AMG coarse solve (the default) or a Chebyshev one, or, at
degree 1 under a multigrid schedule, by the AMG V-cycle alone (PCGAMG), and
exposes solve / postprocessing entry points. Every residual, every CG
matvec, every level J.v and the AMG's level-0 matvec go through the fused
element apply (ops/fused_apply.py), which on a CUDA device is the
hand-written kernel. hyperFSIncomp is a composite operator: its deviatoric
mu part at full quadrature plus its pressure part at Q = 1 + qextra points
a direction, each with its own stash. A preconditioner build makes one
pointwise tangent (ops/assembly.pointwise_tangent) a quadrature rule of
the Jacobian, and takes every level's diagonal and the AMG's p = 1
element matrices from it, as the distributed driver (parallel/driver.py)
does; the boundary values are computed once a load. The nodal diagnostics
(`diagnostics`, written to VTU files by post/vtu.py) are evaluated in
float64 on the problem's device; a solve can stop at a load
(`Config.stop_at_load`) and resume from a checkpoint
(`solve(u0=, start_load=, floor_atol0=)`).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .device import default_dtype, select_device
from .mesh.box import box_mesh
from .mesh.fespace import FESpace, build_fespace
from .models import Physics, get_model, mms
from .models.boundary import BoundaryConditions
from .models.forcing import assemble_forcing
from .ops.assembly import (CSRAssembler, diagonal_weights,
                           element_diagonal_of, element_matrices_of,
                           pointwise_tangent)
from .ops.fused_apply import PHYSICS, require_fits
from .ops.operator import OperatorFactory
from .solve.amg import AMGPreconditioner
from .solve.cg import estimate_extreme_eigs, pcg
from .solve.newton import NewtonOptions, NewtonResult, newton_solve
from .solve.pmg import MGLevel, make_vcycle
from .utils.timing import StageLog, count, request, span, sync


@dataclass
class Config:
    """CLI-equivalent options (reference src/cloptions.c:26-285).

    `mesh_file` (an Exodus-II file) replaces the box. On CUDA every degree
    runs the hand-written fused apply: above the shared memory of a block
    its generic tile spreads an element over a thread-block cluster (the
    cluster body) and, beyond what 8 CTAs hold, keeps an element's buffers
    in global memory (the gmem body); a (P, Q) above its range (P or
    Q > 64) raises
    NotImplementedError (ops/fused_apply.require_fits). The JAX package's
    `pc_precision` (bf16 MXU passes inside the V-cycle) has no counterpart:
    float32 contractions here run in IEEE f32 with TF32 off."""

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
    multigrid: str = "logarithmic"              # logarithmic | uniform | none
    nu_smoother: float = 0.0
    test_mode: bool = False
    # Preconditioner-level quadrature: "native" integrates each coarse
    # p-MG level at its own Gauss rule Q_l = degree_l + 1 + qextra, with the
    # stashed gradu re-interpolated exactly onto it; "fine" shares the fine
    # level's quadrature, qdata and stash like the reference
    # (src/setuplibceed.c:756-757). The fine operator is the same either way.
    level_quadrature: str = "native"
    # units (cloptions.c:237-282)
    units_meter: float = 1.0
    units_second: float = 1.0
    units_kilogram: float = 1.0
    # solver knobs
    ksp_rtol: float = 1e-10
    ksp_max_it: int = 10_000
    ksp_monitor: bool = False                   # -ksp_monitor
    smooth_its: int = 3                         # PCMGSetNumberSmooth(3)
    coarse_solve: str = "amg"                   # amg (GAMG analog) | chebyshev
    coarse_cheb_its: int = 30                   # Chebyshev coarse solve
    # rebuild the level diagonals, Chebyshev bounds and AMG values every
    # pc_lag Newton iterations (1 = the reference's per-Jacobian cadence,
    # misc.c:151-183; a linear model builds them once a solve); CG always
    # applies the fresh Jacobian
    pc_lag: int = 1
    newton: NewtonOptions = field(default_factory=NewtonOptions)
    # failed-increment retries with a halved load delta (0: the reference's
    # behaviour, the continuation loop breaks on the first divergence)
    substep_retries: int = 4
    # stop the continuation once this load fraction is reached (None: run
    # every increment); with solve(u0=, start_load=, floor_atol0=) a solve
    # can be cut at a load and resumed there
    stop_at_load: float | None = None
    # None: CUDA, raising without one (select_device); dtype None: per
    # default_dtype
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
        self.level_degrees()                    # unknown schedules raise
        if self.level_quadrature not in ("native", "fine"):
            raise ValueError(
                f"unknown level_quadrature {self.level_quadrature!r}")
        if self.coarse_solve not in ("amg", "chebyshev"):
            raise ValueError(f"unknown coarse solve {self.coarse_solve!r}")
        self.device = select_device(self.device)
        if self.dtype is None:
            self.dtype = default_dtype(self.device)
        if self.device.type == "cuda":
            # the fine level's (P, Q) is the largest of the problem (coarse
            # levels and the pressure term have fewer nodes or points)
            P = self.degree + 1
            require_fits(get_model(self.problem).name, P, P + self.qextra)

    @property
    def pascal(self) -> float:
        return self.units_kilogram / (self.units_meter * self.units_second**2)

    def level_degrees(self) -> list[int]:
        """Multigrid level schedule (cloptions.c:196-225), coarse -> fine."""
        p = self.degree
        if self.multigrid == "logarithmic":
            n = int(math.ceil(math.log2(p))) + 1 if p > 1 else 1
            degs = [2**i for i in range(max(n - 1, 0))] + ([p] if n > 1 else [])
            return degs if degs else [p]
        if self.multigrid == "uniform":
            return list(range(1, p + 1))
        if self.multigrid == "none":
            return [p]
        raise ValueError(f"unknown multigrid type {self.multigrid!r}")


def _flatwrap(apply_cm):
    """Adapt a component-major (3, nn) -> (3, nn) operator apply to the flat
    node-major (3 nn,) vectors the AMG cycle works on."""
    def fn(xf):
        return apply_cm(xf.reshape(-1, 3).T.contiguous()).T.reshape(-1)
    return fn


class ElasticityProblem:
    """Owns mesh, spaces, operators, BCs, forcing, and the solve loop."""

    def __init__(self, config: Config, mesh=None):
        self.config = config
        self.device = config.device
        self.dtype = config.dtype
        self.log = StageLog(self.device)

        # --- mesh ("DM and Vector Setup" stage, elasticity.c:128-131) ----
        with self.log.stage("DM and Vector Setup"):
            if mesh is None and config.mesh_file:
                from .mesh.exodus import read_exodus
                from .mesh.reorder import reorder_mesh

                # file order or Morton, whichever gives the smaller
                # contiguous-block halo, and first-use vertex numbering
                # (the JAX package's problem.py does the same)
                mesh = reorder_mesh(read_exodus(config.mesh_file))
            elif mesh is None:
                mesh = box_mesh(config.box_faces, config.box_lower,
                                config.box_upper)
            self.mesh = mesh
            # FE spaces per level (coarse -> fine)
            self.level_degrees = config.level_degrees()
            self.spaces: list[FESpace] = [build_fespace(mesh, d)
                                          for d in self.level_degrees]
            self.fine_space = self.spaces[-1]

        # --- operators ("Operator Setup", elasticity.c:230-233) ----------
        with self.log.stage("Operator Setup"):
            fes = self.fine_space
            self.factory = OperatorFactory(self.spaces, qextra=config.qextra,
                                           dtype=self.dtype, device=self.device)
            self.qdata = self.factory.compute_qdata()
            self.model = get_model(config.problem)
            self.phys = Physics(nu=config.nu, E=config.E * config.pascal)
            # smoother physics for the diagonals (-nu_smoother, matops.c:215-232)
            self._diag_phys = (Physics(nu=config.nu_smoother,
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
            self._bc_vals = {}          # load -> bc_values(load)

            # --- forcing (zero at constrained DOFs: not solved for) -------
            F = assemble_forcing(self.factory, self.qdata, config.forcing,
                                 phys=self.phys, forcing_vec=config.forcing_vec)
            self.F = torch.where(self.bc_mask, 0.0, F)

            nlev = len(self.spaces)
            pw = PHYSICS[self.model.name]
            self._res = self.factory.make_residual_structured(pw, self.phys)
            self._jac_lvls = [self.factory.make_jacobian_structured(
                pw, self.phys, level=l) for l in range(nlev)]
            self.composite = bool(getattr(self.model, "composite", False))
            if self.composite:
                # reduced-integration pressure operator (hyperFSIncomp): its
                # own P -> 1 basis and Q = 1 qdata on every level, the
                # restrictions shared (src/setuplibceed.c:404-506)
                self.pfactory = OperatorFactory(
                    self.spaces, qextra=config.qextra, dtype=self.dtype,
                    device=self.device, q1d=1 + config.qextra,
                    share=self.factory)
                self.qdata_p = self.pfactory.compute_qdata()
                pwp = PHYSICS[self.model.pressure_name]
                self._res_p = self.pfactory.make_residual_structured(
                    pwp, self.phys)
                self._jac_p = [self.pfactory.make_jacobian_structured(
                    pwp, self.phys, level=l) for l in range(nlev)]
            self._energy_fn = self.factory.make_energy(self.model.energy_qf,
                                                       self.phys)
            # native-quadrature preconditioner levels (all but the fine one)
            self._use_native_levels = (config.level_quadrature == "native"
                                       and nlev > 1)
            nat = range(nlev - 1) if self._use_native_levels else ()
            self._jac_nat = [
                self.factory.make_jacobian_native(pw, self.phys, l)
                for l in nat]
            self._qdata_nat = [self.factory.compute_qdata_native(l)
                               for l in nat]
            # each level's diagonal weights at its rule (the pressure
            # part's too): its element diagonals come from the pointwise
            # tangent at that rule (`_tangent`)
            self._diag_w = [
                (diagonal_weights(self._level_basis(l)),
                 diagonal_weights(self.pfactory.levels[l].basis)
                 if self.composite else None)
                for l in range(nlev)]
            # the tangents of the preconditioner build in progress, by
            # rule (`_tangent_scope`); None outside a build
            self._tangents = None
            self._use_mg = config.multigrid != "none" and nlev > 1
            if self._use_mg:
                self._level_masks = [self._level_mask(s) for s in self.spaces]
                self._transfers = [None] + [
                    self.factory.make_prolongation(l - 1, l)
                    for l in range(1, nlev)]
            # the AMG: the p-MG coarse solve, or at degree 1 under a
            # multigrid schedule the whole preconditioner (PCGAMG,
            # elasticity.c:519-521)
            self._use_amg = (config.coarse_solve == "amg"
                             and config.multigrid != "none")
            if self._use_amg:
                with span("setup/amg"):
                    self._setup_amg()
        self.setup_time = sum(self.log.seconds().values())
        self._pc_cache = None
        # the totals of the last request (utils/timing.request) this
        # problem ran: amg_times, pc_setups
        self._last_totals = None
        self.cg_exits = {}          # CGResult.reason -> count, last solve
        self._diagnostic = None     # (apply, qd_coll, mult), built at first use

    def _setup_amg(self):
        """The fixed-pattern CSR assembler of the p = 1 space and the AMG
        over it (level 0 matrix-free); its values come from level 0's
        pointwise tangent (p1_values)."""
        s0 = self.spaces[0]
        self._assembler0 = CSRAssembler(
            s0.conn, s0.num_nodes, self._level_mask(s0).cpu().numpy(),
            device=self.device)
        self._amg = AMGPreconditioner(self.dtype, self.device, top_mf=True)

    @property
    def amg_times(self) -> dict | None:
        """Seconds of the AMG refreshes in the last request (a solve, or a
        linear solve run alone; inside pc_time), by part: the element
        matrices, the copy to the host, the setup (the host CSR, the native
        setup and the device refresh's plans at the first build; the device
        refresh's Galerkin products, lambdas and coarse inverse after it)
        and the upload, from its pc/amg/* spans; None without the AMG."""
        if not self._use_amg:
            return None
        sec = self._last_totals.seconds if self._last_totals else {}
        setup = ("csr", "native", "plan", "galerkin", "lam", "coarse")
        return {"elem_mats": sec.get("pc/amg/elem_mats", 0.0),
                "d2h": sec.get("pc/amg/d2h", 0.0),
                "setup": sum(sec.get(f"pc/amg/{k}", 0.0) for k in setup),
                "upload": sec.get("pc/amg/upload", 0.0)}

    @property
    def pc_setups(self) -> int:
        """Preconditioner builds in the last request (counter pc.builds)."""
        return (self._last_totals.counts.get("pc.builds", 0)
                if self._last_totals else 0)

    # ------------------------------------------------------------------
    def bc_values(self, load_increment: float) -> torch.Tensor:
        """(3, nnodes) boundary values at a load, computed once a load and
        kept (they depend on nothing else); no caller changes them in
        place."""
        v = self._bc_vals.get(load_increment)
        if v is None:
            v = self._bc_vals[load_increment] = torch.as_tensor(
                np.ascontiguousarray(
                    self.bcs.values(self._coords, load_increment).T),
                dtype=self.dtype, device=self.device)
        return v

    def insert_bc(self, u: torch.Tensor, bc_vals: torch.Tensor) -> torch.Tensor:
        """DMPlexInsertBoundaryValues analog (matops.c:70-73)."""
        return torch.where(self.bc_mask, bc_vals, u)

    def _level_mask(self, space: FESpace) -> torch.Tensor:
        """Constrained-DOF mask (3, nnodes_l) of a level's space (the same
        BC face sets)."""
        cfg = self.config
        bcs = BoundaryConditions(num_nodes=space.num_nodes)
        if cfg.test_mode or cfg.forcing == "mms":
            bcs.add_mms(space.all_boundary_nodes())
        else:
            for face in cfg.bc_clamp:
                bcs.add_clamp(space.face_set_nodes(face), np.zeros(7))
        return torch.as_tensor(np.ascontiguousarray(bcs.mask().T),
                               device=self.device)

    def _nat_level(self, l: int) -> bool:
        return self._use_native_levels and l < len(self.spaces) - 1

    def _level_basis(self, l: int):
        """Level l's basis at its rule: its own Gauss rule on a native
        level, else the fine one."""
        lvl = self.factory.levels[l]
        return lvl.nat_basis if self._nat_level(l) else lvl.basis

    @contextlib.contextmanager
    def _tangent_scope(self):
        """One preconditioner build: the pointwise tangents made inside it
        are kept by rule until the outermost scope ends, so each rule's is
        made once a Jacobian; a nested scope shares the open one."""
        if self._tangents is not None:
            yield
            return
        self._tangents = {}
        try:
            yield
        finally:
            self._tangents = None

    def _tangent(self, l, stash, stash_nats, phys=None) -> torch.Tensor:
        """The mu part's pointwise tangent (ops/assembly.pointwise_tangent)
        at level l's rule, its native one or the fine one; l None: the
        pressure part's, at its Q = 1 + qextra rule. Made at its first use in
        a build (span pc/tangent) and kept to the build's end
        (_tangent_scope); outside a build made and dropped."""
        phys = self.phys if phys is None else phys
        nat = l is not None and self._nat_level(l)
        # -nu_smoother's diagonals take their own physics
        key = ("p" if l is None else l if nat else "fine", phys is self.phys)
        cache = self._tangents
        K = None if cache is None else cache.get(key)
        if K is None:
            if l is None:
                qf, qdata, st = (self.model.pressure_jacobian_qf,
                                 self.qdata_p, stash[1])
            elif nat:
                qf, qdata = self.model.jacobian_qf, self._qdata_nat[l]
                st = (stash_nats[l] if stash_nats is not None else
                      self.factory.stash_to_native(self._mu(stash), l))
            else:
                qf, qdata, st = (self.model.jacobian_qf, self.qdata,
                                 self._mu(stash))
            with span("pc/tangent"):
                K = pointwise_tangent(qf, phys, qdata, st)
            if cache is not None:
                cache[key] = K
        return K

    def _mu(self, stash):
        """The full-quadrature stash (the mu part's of a composite pair)."""
        return stash[0] if self.composite else stash

    def _raw_residual(self, u):
        """Unmasked residual L-vector and stash; a composite model's stash
        is the (mu, pressure) pair."""
        r, stash = self._res(u, self.qdata)
        if self.composite:
            rp, stash_p = self._res_p(u, self.qdata_p)
            return r + rp, (stash, stash_p)
        return r, stash

    def _raw_jacobian(self, v, stash, level=-1):
        """Unmasked J_l v at the fine quadrature (plus the pressure term)."""
        jv = self._jac_lvls[level](v, self.qdata, self._mu(stash))
        if self.composite:
            jv = jv + self._jac_p[level](v, self.qdata_p, stash[1])
        return jv

    def _nonlinear_residual(self, u, bc_vals, F):
        """G(u) = R(u with BCs inserted) - F, zeroed at constrained DOFs
        (FormResidual_Ceed, matops.c:63-79). Returns (G, stash)."""
        with span("newton/residual"):
            r, stash = self._raw_residual(self.insert_bc(u, bc_vals))
            return torch.where(self.bc_mask, 0.0, r - F), stash

    def _jacobian_action(self, v, stash):
        """Zero-BC linearized action (ApplyJacobian_Ceed, matops.c:98-112)."""
        jv = self._raw_jacobian(torch.where(self.bc_mask, 0.0, v), stash)
        return torch.where(self.bc_mask, 0.0, jv)

    # ------------------------------------------------------------------
    # p-multigrid (elasticity.c:524-590)
    # ------------------------------------------------------------------
    def build_mg_levels(self, stash) -> tuple[list[MGLevel], list]:
        """The V-cycle's levels for one Jacobian, and the native-level
        stashes, interpolated here once per Jacobian (not per apply). A
        composite model's native levels interpolate the mu stash only; its
        pressure term rides on its Q = 1 level path."""
        nlev = len(self.spaces)
        stash_nats = [self.factory.stash_to_native(self._mu(stash), l)
                      if self._nat_level(l) else None for l in range(nlev)]
        levels = []
        for l in range(nlev):
            lm = self._level_masks[l]
            if self._nat_level(l):
                def apply(v, stash_, l=l, lm=lm, sn=stash_nats[l]):
                    vm = torch.where(lm, 0.0, v)
                    jv = self._jac_nat[l](vm, self._qdata_nat[l], sn)
                    if self.composite:
                        jv = jv + self._jac_p[l](vm, self.qdata_p, stash_[1])
                    return torch.where(lm, 0.0, jv)
            else:
                def apply(v, stash_, l=l, lm=lm):
                    jv = self._raw_jacobian(torch.where(lm, 0.0, v), stash_, l)
                    return torch.where(lm, 0.0, jv)
            pro, res = self._transfers[l] or (None, None)
            levels.append(MGLevel(apply=apply, mask=lm, prolong=pro,
                                  restrict=res,
                                  degree=self.level_degrees[l]))
        return levels, stash_nats

    def level_diag(self, l: int, stash, stash_nats) -> torch.Tensor:
        """Assembled diagonal of level l's operator (unmasked): the element
        diagonals of its rule's tangent, owner-summed, the pressure term's
        added for a composite model."""
        restr = self.factory.levels[l].restr
        w, w_p = self._diag_w[l]
        d = restr.scatter_add(element_diagonal_of(
            self._tangent(l, stash, stash_nats, self._diag_phys), w))
        if self.composite:
            d = d + restr.scatter_add(element_diagonal_of(
                self._tangent(None, stash, stash_nats, self._diag_phys), w_p))
        return d

    def mg_setup(self, stash, levels, stash_nats):
        """Per-level inverse diagonals + Chebyshev bounds: the
        KSPChebyshevEstEig analog (elasticity.c:539-545), run once per
        Jacobian refresh, never inside CG."""
        diag_invs, bounds = [], []
        with self._tangent_scope():
            for l, lvl in enumerate(levels):
                with span(f"pc/mg/p{lvl.degree}/diag"):
                    d = torch.where(lvl.mask, 1.0,
                                    self.level_diag(l, stash, stash_nats))
                    dinv = 1.0 / d
                diag_invs.append(dinv)
                with span(f"pc/mg/p{lvl.degree}/eig"):
                    bounds.append(estimate_extreme_eigs(
                        lambda v, lvl=lvl: lvl.apply(v, stash), dinv,
                        d.shape, d.dtype))
        return diag_invs, bounds

    def _amg_apply(self, b, data, top_mv):
        """(3, nn0) residual -> one AMG V-cycle (node-major flat inside);
        top_mv is the flat level-0 matvec (see AMGPreconditioner.apply)."""
        xf = self._amg.apply(b.T.reshape(-1), data, top_matvec=top_mv)
        return xf.reshape(-1, 3).T.contiguous()

    def p1_values(self, stash, stash_nats=None) -> torch.Tensor:
        """(nnz,) float64 values of the assembled p = 1 matrix (before its
        BC masks), on the device: element matrices in the solve dtype from
        level 0's tangent (the mu part at the native level-0 quadrature
        when native levels are on, plus the pressure part), then the
        fixed-order slot reduction."""
        em = element_matrices_of(self._tangent(0, stash, stash_nats),
                                 self._level_basis(0).grad)
        if self.composite:
            em = em + element_matrices_of(
                self._tangent(None, stash, stash_nats),
                self.pfactory.levels[0].basis.grad)
        return self._assembler0.assemble_values(em).to(torch.float64)

    def refresh_amg(self, stash, stash_nats=None):
        """FormJacobian analog (misc.c:151-183): the p = 1 values on the
        device (p1_values), then the hierarchy's values refreshed from them
        on the device (AMGPreconditioner.refresh), or, at the first build,
        the (nnz,) float64 vector to the host, the native AMG setup and the
        levels back to the device; each in a pc/amg/* span (amg_times)."""
        with span("pc/amg/elem_mats"):
            vals = self.p1_values(stash, stash_nats)
            sync(self.device)
        asm = self._assembler0
        if self._amg.refreshes_from(asm):
            self._amg.refresh(vals)
            return
        with span("pc/amg/d2h"):
            host = vals.cpu().numpy()
        with span("pc/amg/csr"):
            A = asm.from_values(host)
        self._amg.setup(A, source=asm)

    def linear_solve_mg(self, G, stash, levels, pc, rtol):
        """p-MG-preconditioned CG for J d = -G; pc = (diag_invs, bounds).
        The coarse solve is one AMG V-cycle whose level 0 is the p-MG
        level-0 apply (node-major <-> component-major through _flatwrap),
        or the Chebyshev polynomial."""
        cfg = self.config
        diag_invs, bounds = pc
        coarse_apply = coarse_data = None
        if self._use_amg:
            top_mv = _flatwrap(lambda v: levels[0].apply(v, stash))

            def coarse_apply(b0, cd):
                return self._amg_apply(b0, cd, top_mv)

            coarse_data = self._amg.data
        vcycle = make_vcycle(levels, smooth_its=cfg.smooth_its,
                             coarse_cheb_its=cfg.coarse_cheb_its,
                             coarse_apply=coarse_apply)
        res = pcg(lambda v: levels[-1].apply(v, stash), -G,
                  M_inv=lambda r: vcycle(r, stash, diag_invs, bounds,
                                         coarse_data),
                  rtol=rtol, maxiter=cfg.ksp_max_it, monitor=cfg.ksp_monitor)
        self.cg_exits[res.reason] = self.cg_exits.get(res.reason, 0) + 1
        return res.x, res.iters

    # ------------------------------------------------------------------
    def _jacobi_setup(self, stash) -> torch.Tensor:
        """Inverse operator diagonal (1 at constrained DOFs)."""
        fine = len(self.spaces) - 1
        d = torch.where(self.bc_mask, 1.0, self.level_diag(fine, stash, None))
        return 1.0 / d

    def _linear_solve(self, G, stash, refresh=True, rtol=None):
        """J d = -G by Jacobi CG (elasticity.c:515-518), p-MG CG, or AMG CG
        at degree 1 (elasticity.c:519-521). The preconditioner data is
        rebuilt once per Jacobian, reused when refresh is False (the pc_lag
        cadence), and built once a solve for a linear model, whose Jacobian
        never changes (the JAX package's cache, problem.py:404-406,
        610-611)."""
        with request("linear_solve") as req:
            x, its = self._linear_solve_impl(G, stash, refresh, rtol)
        self._last_totals = req.totals
        return x, its

    def _linear_solve_impl(self, G, stash, refresh, rtol):
        cfg = self.config
        rtol = cfg.ksp_rtol if rtol is None else rtol
        with span("pc"):
            levels = stash_nats = None
            if self._use_mg:
                with span("pc/mg/levels"):
                    levels, stash_nats = self.build_mg_levels(stash)
            if self._pc_cache is None or (refresh and self.model.nonlinear):
                count("pc.builds")
                with self._tangent_scope():
                    if self._use_amg:
                        self.refresh_amg(stash, stash_nats)
                    if self._use_mg:
                        self._pc_cache = self.mg_setup(stash, levels,
                                                       stash_nats)
                    else:   # Jacobi; PCGAMG needs only the AMG data
                        self._pc_cache = (() if self._use_amg
                                          else self._jacobi_setup(stash))
            sync(self.device)
        if self._use_mg:
            return self.linear_solve_mg(G, stash, levels, self._pc_cache, rtol)
        if self._use_amg:
            top_mv = _flatwrap(lambda v: self._jacobian_action(v, stash))

            def M_inv(r):
                return torch.where(self.bc_mask, 0.0,
                                   self._amg_apply(r, self._amg.data, top_mv))
        else:
            diag_inv = self._pc_cache

            def M_inv(r):
                return diag_inv * r
        res = pcg(lambda v: self._jacobian_action(v, stash), -G, M_inv=M_inv,
                  rtol=rtol, maxiter=cfg.ksp_max_it, monitor=cfg.ksp_monitor)
        self.cg_exits[res.reason] = self.cg_exits.get(res.reason, 0) + 1
        return res.x, res.iters

    # ------------------------------------------------------------------
    def solve(self, monitor=None, u0=None, start_load: float = 0.0,
              floor_atol0: float = 0.0) -> "SolveInfo":
        """Load-increment continuation loop (elasticity.c:636-673).

        monitor(inc, load, NewtonResult) is called after every Newton
        solve, sub-steps and failed ones included. u0 / start_load /
        floor_atol0 resume the continuation from a checkpoint (a capability
        the reference lacks): the state u (3, nnodes), which is converted
        to the problem's dtype and device, the load it converged at, and
        the largest final rnorm of the increments accepted before it. A
        caller checkpoints (res.u, load, that maximum) from the monitor;
        a JAX package checkpoint is (interop.u_from_jax(u, device=...), load,
        floor).
        """
        with self.log.stage("SNES Solve"):
            return self._solve_impl(monitor, u0, start_load, floor_atol0)

    def _solve_impl(self, monitor, u0, start_load, floor_atol0) -> "SolveInfo":
        cfg = self.config
        N = self.fine_space.num_nodes
        if u0 is None:
            u = torch.zeros((3, N), dtype=self.dtype, device=self.device)
        else:
            u = torch.as_tensor(u0).to(device=self.device, dtype=self.dtype)
        self._pc_cache = None
        self.cg_exits = {}
        with request("solve") as req:
            u, load_done, info = self._continuation(monitor, u, start_load,
                                                    floor_atol0)
            sync(self.device)
        self._last_totals = req.totals
        info.solve_time = req.seconds
        info.pc_time = req.totals.seconds.get("pc", 0.0)
        with span("newton/bc"):
            info.u = self.insert_bc(u, self.bc_values(max(load_done, 1e-30)))
        return info

    def _continuation(self, monitor, u, start_load, floor_atol0):
        """The load increments' Newton solves from u: (u, the load reached,
        a SolveInfo without u and times)."""
        cfg = self.config
        N = self.fine_space.num_nodes
        total_snes = total_ksp = 0
        rnorm = 0.0
        last = None
        load_done = float(start_load)
        floor_atol = float(floor_atol0)

        def run_newton(load, u0):
            with span("newton/bc"):
                bc_vals = self.bc_values(load)
            F = self.F * load
            nstep = [0]

            def residual(uu):
                return self._nonlinear_residual(uu, bc_vals, F)

            def linear_solve(uu, G, stash, eta=None):
                refresh = nstep[0] % max(cfg.pc_lag, 1) == 0
                nstep[0] += 1
                # Eisenstat-Walker forcing: never tighter than ksp_rtol
                rtol = None if eta is None else max(cfg.ksp_rtol, eta)
                return self._linear_solve(G, stash, refresh=refresh, rtol=rtol)

            return newton_solve(residual, linear_solve, u0, cfg.newton,
                                floor_atol=floor_atol)

        for inc in range(1, cfg.num_increments + 1):
            target = inc / cfg.num_increments
            if cfg.stop_at_load is not None and \
                    target > cfg.stop_at_load + 1e-12:
                break
            # adaptive sub-stepping: a failed increment retries from the
            # last converged state with a halved load delta (the reference
            # breaks the continuation instead, elasticity.c:668-672)
            delta = target - load_done
            fails = 0
            while load_done < target - 1e-12:
                load = min(target, load_done + delta)
                try:
                    res: NewtonResult = run_newton(load, u)
                except FloatingPointError:
                    # non-finite data reached the AMG's coarse
                    # pseudo-inverse: a diverged increment, as in the JAX
                    # package
                    res = NewtonResult(u, 0, 0, float("nan"), False,
                                       "diverged (non-finite)")
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
                    if fails > cfg.substep_retries:
                        break
            if load_done < target - 1e-12:
                break  # elasticity.c:668-672 (after sub-step retries)
        return u, load_done, SolveInfo(
            u=None,
            snes_iters=total_snes,
            ksp_iters=total_ksp,
            rnorm=rnorm,
            converged=bool(last.converged) if last else True,
            reason=last.reason if last else "",
            solve_time=0.0,
            dofs=3 * N,
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

    def diagnostics(self, u: torch.Tensor) -> torch.Tensor:
        """(nnodes, 8) float64 nodal diagnostic fields (misc.c:217-311) on
        the problem's device: ux, uy, uz, pressure, volumetric strain,
        tr(E^2), detJ and the strain energy density (the model's
        diagnostic_qf). The operator and its geometry are built at the first
        call (OperatorFactory.make_diagnostic, diagnostic_setup)."""
        if self._diagnostic is None:
            self._diagnostic = (
                self.factory.make_diagnostic(self.model.diagnostic_qf,
                                             self.phys),
                *self.factory.diagnostic_setup())
        apply, qd_coll, mult = self._diagnostic
        return apply(u, qd_coll, mult)


@dataclass
class SolveInfo:
    u: torch.Tensor
    snes_iters: int
    ksp_iters: int
    rnorm: float
    converged: bool
    reason: str
    # the request's span (utils/timing.request "solve"): the load
    # increments' Newton solves to the device's sync, no BC insertion
    solve_time: float
    dofs: int
    # preconditioner setups (diagonals, Chebyshev bounds, native stashes,
    # AMG refreshes), inside solve_time: the request's "pc" spans
    pc_time: float = 0.0

    @property
    def mdofs_per_sec(self) -> float:
        """1e-6 * dofs * ksp_iters / time (elasticity.c:763-764)."""
        if self.solve_time == 0:
            return 0.0
        return 1e-6 * self.dofs * self.ksp_iters / self.solve_time
