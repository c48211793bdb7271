"""Matrix-free FEM operator pipeline (the CeedOperator analog).
Port of the conn-path subset of ceedpetscsolid_tpu/ops/operator.py.

An operator application is gather (G) -> basis grad (B) -> pointwise
physics (D) -> B^T -> scatter (G^T), the A = G^T B^T D B G decomposition of
the reference (src/setuplibceed.c:529-542). Every model's residual and
Jacobian run the first four stages as one fused element apply
(ops/fused_apply.py: the hand-written CUDA kernel on the GPU, plain torch on
the CPU), its pointwise physics named by a fused_apply.PHYSICS entry; the
owner-sum is the deterministic Restriction.scatter_add. Under the profiler
the fused residual and J.v are spans, op/residual and op/jv, beside the
owner-sum's op/owner_sum (utils/timing.fine).

One factory serves every p-multigrid level (spaces coarse -> fine). Each
level applies its physics either at the FINE level's Gauss points through a
P_l -> Q_fine basis with the shared fine qdata and stash (the reference's
choice, src/setuplibceed.c:756-757), or at its own Gauss rule
Q_l = degree_l + 1 + qextra with its own qdata and the stash re-interpolated
exactly onto that rule (`LevelOps.stash_interp`, the JAX package's
native-quadrature levels). A factory built with `q1d` integrates every level
at that rule instead: hyperFSIncomp's reduced-integration pressure term
(Q = 1 + qextra), which has no native levels.

Box and unstructured meshes take the same conn path. The JAX package's
TPU-layout machinery (class-row restrictions, lattice/spectral box paths,
lane-padded qdata) has no counterpart here.

Layouts: nodal fields (3, num_nodes); element fields (3, nelem, P3);
quadrature tensors (3, 3, nelem, Q3); qdata (10, nelem, Q3); stash
(9, nelem, Q3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..device import default_dtype, select_device
from ..mesh.fespace import FESpace
from ..models.base import Mat3
from ..utils.timing import fine
from . import fused_apply, geometry
from .basis import Basis3D, _kron3, lagrange_matrices
from .quadrature import gauss
from .restriction import Restriction


@dataclass
class LevelOps:
    """Per-level operator data (ceedpetscsolid_tpu/ops/operator.py:73-103).

    nat_basis and stash_interp are None on the fine level, which always
    integrates at the fine rule."""

    space: FESpace
    restr: Restriction
    basis: Basis3D                          # P_l -> Q_fine (Gauss)
    nat_basis: Basis3D | None = None        # P_l -> Q_l (Gauss)
    stash_interp: torch.Tensor | None = None  # (Q3_fine, Q3_l), exact


class OperatorFactory:
    """Builds operator closures for one problem configuration: one space,
    or one per multigrid level (coarse -> fine)."""

    def __init__(self, spaces: FESpace | list[FESpace], qextra: int = 0,
                 dtype=None, device=None, q1d: int | None = None,
                 share: "OperatorFactory | None" = None):
        """device: None is CUDA, raising without a CUDA device
        (device.select_device); the CPU runs only when named. dtype: None
        is device.default_dtype, float32 on CUDA and float64 on the CPU,
        as ElasticityProblem chooses. q1d overrides
        the quadrature size (the reduced-integration pressure operator of
        hyperFSIncomp, Q = 1 + qextra, src/setuplibceed.c:406). share: a
        factory over the same spaces whose restrictions this one reuses
        (identical index maps)."""
        if isinstance(spaces, FESpace):
            spaces = [spaces]
        self.device = select_device(device)
        self.dtype = dtype = (default_dtype(self.device) if dtype is None
                              else dtype)
        fine = spaces[-1]
        # setuplibceed.c:252
        self.Q1d = q1d if q1d is not None else fine.degree + 1 + qextra
        self.Q3 = self.Q1d ** 3
        self.nelem = fine.conn.shape[0]
        self.levels: list[LevelOps] = []
        for i, s in enumerate(spaces):
            lvl = LevelOps(
                space=s,
                restr=(share.levels[i].restr if share is not None else
                       Restriction(s.conn, s.num_nodes,
                                   node_ranges=s.entity_node_ranges(),
                                   device=self.device)),
                basis=Basis3D.create(s.degree + 1, self.Q1d, "gauss", dtype,
                                     device=self.device))
            if s.degree != fine.degree and q1d is None:
                Qn = s.degree + 1 + qextra
                lvl.nat_basis = Basis3D.create(s.degree + 1, Qn, "gauss",
                                               dtype, device=self.device)
                B1, _ = lagrange_matrices(gauss(self.Q1d)[0], gauss(Qn)[0])
                lvl.stash_interp = torch.as_tensor(
                    np.ascontiguousarray(_kron3(B1, B1, B1).T), dtype=dtype,
                    device=self.device)
            self.levels.append(lvl)
        self.fine = self.levels[-1]
        # the fine level under its single-space names
        self.space, self.restr, self.basis = fine, self.fine.restr, self.fine.basis
        mesh = fine.mesh
        # coordinate (vertex) restriction: trilinear geometry basis 2 -> Q
        self.coord_restr = (share.coord_restr if share is not None else
                            Restriction(mesh.connectivity, mesh.num_vertices,
                                        device=self.device))
        self.vertex_coords = torch.as_tensor(      # float64; cast per use
            np.ascontiguousarray(mesh.vertices.T), device=self.device)

    def _coords_and_basis(self, dtype, Q1d=None):
        """Element vertex coordinates (3, nelem, 8) and the trilinear
        coordinate basis (2 -> Q), in `dtype`."""
        cb = Basis3D.create(2, Q1d or self.Q1d, "gauss", dtype,
                            device=self.device)
        return self.coord_restr.gather(self.vertex_coords.to(dtype)), cb

    # ------------------------------------------------------------------
    def compute_qdata(self, dtype=None) -> torch.Tensor:
        """(10, nelem, Q3) geometric factors (working dtype unless given);
        computed once at setup."""
        xe, cb = self._coords_and_basis(dtype or self.dtype)
        dxdX = cb.apply_grad(xe)                               # (3,3,e,Q3)
        return geometry.setup_geo(dxdX, cb.qweights).contiguous()

    def compute_qdata_native(self, level: int) -> torch.Tensor:
        """(10, nelem, Q3_level) geometric factors at the level's own Gauss
        rule (native-quadrature preconditioner levels)."""
        xe, cb = self._coords_and_basis(self.dtype,
                                        self.levels[level].nat_basis.Q)
        return geometry.setup_geo(cb.apply_grad(xe), cb.qweights).contiguous()

    def stash_to_native(self, stash: torch.Tensor | None,
                        level: int) -> torch.Tensor | None:
        """Fine-quadrature stash (9, nelem, Q3f) -> (9, nelem, Q3_level) by
        the exact fine-Gauss -> level-Gauss interpolation (gradu components
        are per-direction polynomials of degree <= p, fixed by their p+1
        Gauss values): one matmul. None (a linear model) stays None."""
        if stash is None:
            return None
        M = self.levels[level].stash_interp
        return (stash.reshape(-1, M.shape[0]) @ M).reshape(
            9, self.nelem, M.shape[1])

    def quad_coords(self) -> torch.Tensor:
        """(3, nelem, Q3) physical coordinates of quadrature points."""
        xe, cb = self._coords_and_basis(self.dtype)
        return cb.apply_interp(xe)

    # ------------------------------------------------------------------
    def make_residual_structured(self, physics, phys) -> Callable:
        """u (3, nnodes), qdata -> (residual L-vector, stash or None) of
        `physics` (a fused_apply.PHYSICS name or Pointwise)."""
        restr, basis = self.restr, self.basis
        pw = fused_apply.pointwise(physics)

        def apply(u, qdata):
            with fine("op/residual"):
                ve, stash = fused_apply.residual(u, restr.conn, qdata, basis,
                                                 phys, pw)
            return restr.scatter_add(ve), stash

        return apply

    def _jacobian_apply(self, physics, phys, restr: Restriction,
                        basis: Basis3D) -> Callable:
        pw = fused_apply.pointwise(physics)

        def apply(v, qdata, stash):
            with fine("op/jv"):
                ve = fused_apply.jacobian(v, restr.conn, qdata, stash, basis,
                                          phys, pw)
            return restr.scatter_add(ve)

        return apply

    def make_jacobian_structured(self, physics, phys,
                                 level: int = -1) -> Callable:
        """v (3, nnodes_l), this factory's qdata, fine stash -> J_l@v at the
        factory's quadrature (P_l -> Q_fine)."""
        lvl = self.levels[level]
        return self._jacobian_apply(physics, phys, lvl.restr, lvl.basis)

    def make_jacobian_native(self, physics, phys, level: int) -> Callable:
        """v (3, nnodes_l), qdata_nat, stash_nat -> J_l@v with the level
        integrated at its own quadrature (see LevelOps)."""
        lvl = self.levels[level]
        return self._jacobian_apply(physics, phys, lvl.restr, lvl.nat_basis)

    def make_energy(self, energy_qf: Callable, phys) -> Callable:
        """u -> total strain energy (0-dim float64 tensor).

        The reference applies a 1-component operator and sums the nodal
        E-vector (src/matops.c:247-296); by partition of unity that equals
        the direct quadrature sum done here. Evaluated in float64 whatever
        the working dtype: the density's first-order terms cancel
        (-mu log J + mu tr(E2)/2), so at small strains a float32 sum is
        rounding noise (1% off at the MMS strains of ~1e-8).
        """
        f64 = torch.float64
        restr = self.restr
        basis = Basis3D.create(self.space.degree + 1, self.Q1d, "gauss", f64,
                               device=self.device)
        qdata = self.compute_qdata(f64)

        def apply(u):
            du = basis.apply_grad(restr.gather(u.to(f64)))
            return torch.sum(energy_qf(du, qdata, phys))

        return apply

    def make_diagnostic(self, diagnostic_qf: Callable, phys) -> Callable:
        """(u (3, nnodes), qd_coll, mult) -> (nnodes, 8) float64 nodal
        diagnostics, averaged over the elements that share each node.

        A collocation P -> P Gauss-Lobatto basis evaluates the model's
        diagnostic_qf at the fine space's own nodes
        (src/setuplibceed.c:347); the element values are summed into the
        nodes and divided by their multiplicity (src/misc.c:258-291).
        (qd_coll, mult) come from diagnostic_setup. Evaluated in float64
        whatever the working dtype, for make_energy's reason: the energy
        density and tr(E^2) columns cancel at small strain as the energy
        does, and a float32 evaluation would write rounding noise."""
        f64 = torch.float64
        restr = self.restr
        P = self.space.degree + 1
        coll = Basis3D.create(P, P, "gauss_lobatto", f64, device=self.device)

        def apply(u, qd_coll, mult):
            ue = restr.gather(u.to(f64))            # values at the GLL nodes
            diag = diagnostic_qf(ue, coll.apply_grad(ue), qd_coll, phys)
            return (restr.scatter_add(diag) / mult).T   # (nnodes, 8)

        return apply

    def diagnostic_setup(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(qd_coll (10, nelem, P3), mult (1, nnodes)) for make_diagnostic,
        float64: the geometry at the fine space's Gauss-Lobatto nodes from
        the trilinear vertex basis (src/setuplibceed.c:347), its weights
        ones (the diagnostics use no wdetJ), and each node's element
        count."""
        f64 = torch.float64
        restr = self.restr
        P = self.space.degree + 1
        cb = Basis3D.create(2, P, "gauss_lobatto", f64, device=self.device)
        dxdX = cb.apply_grad(self.coord_restr.gather(self.vertex_coords))
        qd_coll = geometry.setup_geo(
            dxdX, torch.ones(P ** 3, dtype=f64, device=self.device))
        mult = restr.scatter_add(torch.ones((1, restr.nelem, restr.P3),
                                            dtype=f64, device=self.device))
        return qd_coll.contiguous(), mult

    # ------------------------------------------------------------------
    def make_prolongation(self, coarse_level: int, fine_level: int):
        """(prolong, restrict) between two levels.

        Prolongation: gather coarse -> Gauss-Lobatto interp P_c -> P_f ->
        scatter-add to fine -> multiply by 1/multiplicity (reference
        src/matops.c:115-157, basis at src/setuplibceed.c:798-803).
        Restriction is its exact transpose (src/matops.c:160-203)."""
        c, f = self.levels[coarse_level], self.levels[fine_level]
        c2f = Basis3D.create(c.space.degree + 1, f.space.degree + 1,
                             "gauss_lobatto", self.dtype, device=self.device)
        rc, rf = c.restr, f.restr
        inv_mult = self.fine_inv_multiplicity(fine_level)

        def prolong(uc):
            return rf.scatter_add(c2f.apply_interp(rc.gather(uc))) * inv_mult

        def restrict(uf):
            return rc.scatter_add(c2f.apply_interp_T(rf.gather(uf * inv_mult)))

        return prolong, restrict

    def fine_inv_multiplicity(self, fine_level: int = -1) -> torch.Tensor:
        """(1, nnodes_l) reciprocal element-sharing count of a level."""
        r = self.levels[fine_level].restr
        return 1.0 / r.scatter_add(torch.ones((1, r.nelem, r.P3),
                                              dtype=self.dtype,
                                              device=self.device))

    # ------------------------------------------------------------------
    def make_diagonal(self, jacobian_qf: Callable, phys, level: int = -1,
                      native: bool = False) -> Callable:
        """Assembled operator diagonal at `level` (CeedOperatorLinear-
        AssembleDiagonal analog, src/matops.c:206-244): the element
        diagonals of `element_diagonal`, owner-summed.
        native=True builds it at the level's own quadrature (qdata and stash
        arguments must then be the native ones).
        """
        lvl = self.levels[level]
        elem = element_diagonal(jacobian_qf, phys,
                                lvl.nat_basis if native else lvl.basis)

        def apply(qdata, stash):
            return lvl.restr.scatter_add(elem(qdata, stash))

        return apply


def element_diagonal(jacobian_qf: Callable, phys, basis: Basis3D) -> Callable:
    """(qdata, stash) -> (3, nelem, P3) element diagonals of an operator:
    diag[c,e,p] = sum_q sum_{d1,d2} Bg[d1,q,p] K[c,d1,c,d2] Bg[d2,q,p]
    where K is the pointwise Jacobian tensor; K's (c, :, c, :) slices
    come from 9 unit-gradient applications of the qfunction."""
    # BB[q, p, d1, d2] = Bg[d1, q, p] * Bg[d2, q, p]
    BB = torch.einsum("aqp,bqp->qpab", basis.grad, basis.grad)

    def fn(qdata, stash):
        nelem, Q3 = qdata.shape[1], qdata.shape[2]
        st = None if stash is None else Mat3(stash.unbind(0))
        diag_e = torch.zeros((3, nelem, basis.P3), dtype=qdata.dtype,
                             device=qdata.device)
        du = torch.zeros((3, 3, nelem, Q3), dtype=qdata.dtype,
                         device=qdata.device)
        for c2 in range(3):
            for d2 in range(3):
                with fine("op/diag"):       # one unit-gradient application
                    du[c2, d2] = 1.0
                    Krow = jacobian_qf(du, qdata, st, phys)[c2]  # (3, e, q)
                    du[c2, d2] = 0.0
                    diag_e[c2] += torch.einsum("qpa,aeq->ep", BB[..., d2],
                                               Krow)
        return diag_e

    return fn
