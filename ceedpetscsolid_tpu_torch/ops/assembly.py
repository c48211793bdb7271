"""Analytic p = 1 element matrices and their fixed-pattern CSR assembly.
Port of ceedpetscsolid_tpu/ops/assembly.py.

Replaces the reference's finite-difference coloring assembly of the coarse
Jacobian (SNESComputeJacobianDefaultColor, src/misc.c:167-173;
DMCreateMatrix, elasticity.c:459-460) with direct analytic assembly: the
pointwise Jacobian tensor K comes from 9 unit-gradient applications of the
model's jacobian_qf (the operator diagonal's trick) and is contracted with
the basis gradients into dense element matrices on the device. The slot
reduction into the CSR value vector also runs on the device, in a fixed
order. The (nnz,) float64 values cross to the host for the native AMG's
first setup only (`from_values`); its later refreshes take them on the
device (`masked`).

BC handling: constrained rows and columns are eliminated and the diagonal
set to 1 (the assembled analog of the solver-level masking).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..models.base import Mat3
from ..utils.timing import fine


def make_element_matrices(jacobian_qf, phys, basis, dtype):
    """fn(qdata, stash) -> (nelem, 3 P3, 3 P3) element matrices, in dtype.

    stash: (9, nelem, Q3) tensor or None. DOF order within the element:
    (node i, component c) -> 3 i + c.
    A_e[(i,c1),(j,c2)]
        = sum_q sum_{d1,d2} Bg[d1,q,i] K[c1,d1,c2,d2](q) Bg[d2,q,j]
    """
    P3 = basis.P3
    grad = basis.grad                       # (3, Q3, P3)

    def fn(qdata, stash):
        nelem, Q3 = qdata.shape[1], qdata.shape[2]
        st = None if stash is None else Mat3(stash.unbind(0))
        cols = []
        for c2 in range(3):
            row = []
            for d2 in range(3):
                # one unit-gradient application, a span under the profiler
                with fine("op/elem_mats"):
                    du = torch.zeros((3, 3, nelem, Q3), dtype=dtype,
                                     device=qdata.device)
                    du[c2, d2] = 1.0
                    # ddv[c1, d1, e, q] = K[c1, d1, c2, d2]
                    row.append(jacobian_qf(du, qdata, st, phys))
            cols.append(torch.stack(row, dim=0))
        K = torch.stack(cols, dim=0)        # (c2, d2, c1, d1, e, q)
        # tmp[c2, d2, c1, i, e, q] = sum_d1 grad[d1, q, i] K[...]
        tmp = torch.einsum("aqi,cdxaeq->cdxieq", grad, K)
        # A2[c2, c1, i, j, e] = sum_{q, d2} tmp * grad[d2, q, j]
        A2 = torch.einsum("cdxieq,dqj->cxije", tmp, grad)
        # element matrix (e, i, c1, j, c2) -> (e, 3 P3, 3 P3)
        return A2.permute(4, 2, 1, 3, 0).reshape(nelem, 3 * P3, 3 * P3)

    return fn


class CSRAssembler:
    """Fixed-pattern CSR assembly of element matrices.

    The pattern (the union of all element DOF pairs, plus the full
    diagonal) is computed once; every refresh recomputes values only, so
    the native AMG hierarchy refreshes in place (csrc/amg.cpp).

    Slot reduction: the flat element-matrix entries that land in each CSR
    slot are tabulated once into padded (slots, K) index blocks, one block
    per multiplicity K, entries in ascending order. A refresh is then one
    gather and one sum per block, in the same order every time: unlike an
    atomic scatter-add, the AMG sees the same values from run to run."""

    def __init__(self, conn: np.ndarray, num_nodes: int, bc_mask: np.ndarray,
                 device):
        nelem, P3 = conn.shape
        nd = 3 * P3
        n = 3 * num_nodes
        dof = (conn[:, :, None].astype(np.int64) * 3
               + np.arange(3)[None, None, :]).reshape(nelem, nd)
        rows = np.repeat(dof, nd, axis=1).ravel()
        cols = np.tile(dof, (1, nd)).ravel()
        keys = rows * n + cols
        # include the full diagonal so BC unit entries always have a slot
        keys = np.concatenate([keys, np.arange(n, dtype=np.int64) * n
                               + np.arange(n, dtype=np.int64)])
        ukeys, inv = np.unique(keys, return_inverse=True)
        self._inv = inv[: rows.size]
        self._nnz = ukeys.size
        self._n = n
        urows = (ukeys // n).astype(np.int64)
        ucols = (ukeys % n).astype(np.int32)
        self.indptr = np.zeros(n + 1, np.int64)
        np.add.at(self.indptr, urows + 1, 1)
        self.indptr = np.cumsum(self.indptr)
        self.indices = ucols
        constrained = np.asarray(bc_mask).T.reshape(-1)       # node-major
        # value masks: zero rows/cols at constrained dofs, 1 on their diagonal
        self._keep = ~constrained[urows] & ~constrained[ucols.astype(np.int64)]
        self._bc_diag = np.where((urows == ucols) & constrained[urows], 1.0,
                                 0.0)
        self._blocks = self._slot_blocks(device)
        self._masks = None      # (keep, bc_diag) on the device, see masked

    def _slot_blocks(self, device):
        """[(slots (m,), entries (m, K))] with K the slot's entry count."""
        inv = self._inv
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=self._nnz)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        blocks = []
        for K in np.unique(counts[counts > 0]):
            slots = np.nonzero(counts == K)[0]
            ent = order[starts[slots][:, None] + np.arange(K)[None, :]]
            blocks.append((torch.as_tensor(slots, device=device),
                           torch.as_tensor(ent, device=device)))
        return blocks

    @property
    def nnz(self) -> int:
        return self._nnz

    def assemble_values(self, elem_mats: torch.Tensor) -> torch.Tensor:
        """elem_mats (nelem, 3 P3, 3 P3) -> (nnz,) CSR values (before the BC
        masks), on elem_mats' device, in its dtype."""
        flat = elem_mats.reshape(-1)
        out = flat.new_zeros(self._nnz)
        for slots, ent in self._blocks:
            out[slots] = flat[ent].sum(dim=1)
        return out

    def masked(self, values: torch.Tensor) -> torch.Tensor:
        """from_values' BC masks on values' device: `assemble_values` in
        float64 -> the assembled matrix's (nnz,) values. The masks go to
        the device at the first call."""
        if self._masks is None:
            self._masks = tuple(
                torch.as_tensor(m, dtype=torch.float64, device=values.device)
                for m in (self._keep, self._bc_diag))
        keep, bc_diag = self._masks
        return values * keep + bc_diag

    def from_values(self, data_host: np.ndarray) -> sp.csr_matrix:
        """Finish the assembly from `assemble_values` copied to the host."""
        data = np.asarray(data_host, np.float64) * self._keep + self._bc_diag
        return sp.csr_matrix((data, self.indices, self.indptr),
                             shape=(self._n, self._n))

    def assemble(self, elem_mats: torch.Tensor) -> sp.csr_matrix:
        """One-shot: element matrices -> scipy CSR (float64)."""
        vals = self.assemble_values(elem_mats)
        return self.from_values(vals.to(torch.float64).cpu().numpy())
