"""Matrix-free FEM operator pipeline (the CeedOperator analog).
Port of the conn-path subset of ceedpetscsolid_tpu/ops/operator.py.

An operator application is gather (G) -> basis grad (B) -> pointwise
physics (D) -> B^T -> scatter (G^T), the A = G^T B^T D B G decomposition of
the reference (src/setuplibceed.c:529-542). The hyperFS residual and
Jacobian run the first four stages as one fused element apply
(ops/fused_apply.py: the hand-written CUDA kernel on the GPU, plain torch on
the CPU); the owner-sum is the deterministic Restriction.scatter_add.

Box and unstructured meshes take the same conn path. The JAX package's
TPU-layout machinery (class-row restrictions, lattice/spectral box paths,
lane-padded qdata) has no counterpart here. Single level: p-multigrid
levels are not ported yet.

Layouts: nodal fields (3, num_nodes); element fields (3, nelem, P3);
quadrature tensors (3, 3, nelem, Q3); qdata (10, nelem, Q3); stash
(9, nelem, Q3).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..mesh.fespace import FESpace
from ..models.base import Mat3
from . import fused_apply, geometry
from .basis import Basis3D
from .restriction import Restriction


class OperatorFactory:
    """Builds operator closures for one problem configuration (one level)."""

    def __init__(self, space: FESpace, qextra: int = 0,
                 dtype=torch.float64, device="cpu"):
        self.dtype = dtype
        self.device = torch.device(device)
        self.space = space
        self.Q1d = space.degree + 1 + qextra             # setuplibceed.c:252
        self.Q3 = self.Q1d ** 3
        self.nelem = space.conn.shape[0]
        self.basis = Basis3D.create(space.degree + 1, self.Q1d, "gauss",
                                    dtype, self.device)
        self.restr = Restriction(space.conn, space.num_nodes,
                                 node_ranges=space.entity_node_ranges(),
                                 device=self.device)
        mesh = space.mesh
        # coordinate (vertex) restriction: trilinear geometry basis 2 -> Q
        self.coord_restr = Restriction(mesh.connectivity, mesh.num_vertices,
                                       device=self.device)
        self.vertex_coords = torch.as_tensor(      # float64; cast per use
            np.ascontiguousarray(mesh.vertices.T), device=self.device)

    def _coords_and_basis(self, dtype):
        """Element vertex coordinates (3, nelem, 8) and the trilinear
        coordinate basis (2 -> Q), in `dtype`."""
        cb = Basis3D.create(2, self.Q1d, "gauss", dtype, self.device)
        return self.coord_restr.gather(self.vertex_coords.to(dtype)), cb

    # ------------------------------------------------------------------
    def compute_qdata(self, dtype=None) -> torch.Tensor:
        """(10, nelem, Q3) geometric factors (working dtype unless given);
        computed once at setup."""
        xe, cb = self._coords_and_basis(dtype or self.dtype)
        dxdX = cb.apply_grad(xe)                               # (3,3,e,Q3)
        return geometry.setup_geo(dxdX, cb.qweights).contiguous()

    def quad_coords(self) -> torch.Tensor:
        """(3, nelem, Q3) physical coordinates of quadrature points."""
        xe, cb = self._coords_and_basis(self.dtype)
        return cb.apply_interp(xe)

    # ------------------------------------------------------------------
    def make_residual_structured(self, phys) -> Callable:
        """hyperFS: u (3, nnodes), qdata -> (residual L-vector, stash)."""
        restr, basis = self.restr, self.basis

        def apply(u, qdata):
            ve, stash = fused_apply.residual(u, restr.conn, qdata, basis, phys)
            return restr.scatter_add(ve), stash

        return apply

    def make_jacobian_structured(self, phys) -> Callable:
        """hyperFS: v (3, nnodes), qdata, stash -> J@v L-vector."""
        restr, basis = self.restr, self.basis

        def apply(v, qdata, stash):
            ve = fused_apply.jacobian(v, restr.conn, qdata, stash, basis, phys)
            return restr.scatter_add(ve)

        return apply

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
                               self.device)
        qdata = self.compute_qdata(f64)

        def apply(u):
            du = basis.apply_grad(restr.gather(u.to(f64)))
            return torch.sum(energy_qf(du, qdata, phys))

        return apply

    def make_diagonal(self, jacobian_qf: Callable, phys) -> Callable:
        """Assembled operator diagonal (CeedOperatorLinearAssembleDiagonal
        analog, src/matops.c:206-244):
        diag[c,e,p] = sum_q sum_{d1,d2} Bg[d1,q,p] K[c,d1,c,d2] Bg[d2,q,p]
        where K is the pointwise Jacobian tensor; K's (c, :, c, :) slices
        come from 9 unit-gradient applications of the qfunction.
        """
        basis, restr = self.basis, self.restr
        # BB[q, p, d1, d2] = Bg[d1, q, p] * Bg[d2, q, p]
        BB = torch.einsum("aqp,bqp->qpab", basis.grad, basis.grad)

        def apply(qdata, stash):
            nelem, Q3 = qdata.shape[1], qdata.shape[2]
            st = Mat3(stash.unbind(0))
            diag_e = torch.zeros((3, nelem, basis.P3), dtype=qdata.dtype,
                                 device=qdata.device)
            du = torch.zeros((3, 3, nelem, Q3), dtype=qdata.dtype,
                             device=qdata.device)
            for c2 in range(3):
                for d2 in range(3):
                    du[c2, d2] = 1.0
                    Krow = jacobian_qf(du, qdata, st, phys)[c2]   # (3, e, q)
                    du[c2, d2] = 0.0
                    diag_e[c2] += torch.einsum("qpa,aeq->ep", BB[..., d2], Krow)
            return restr.scatter_add(diag_e)

        return apply
