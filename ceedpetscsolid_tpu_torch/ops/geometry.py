"""Geometric quadrature data (the SetupGeo QFunction analog).
Port of ceedpetscsolid_tpu/ops/geometry.py.

From the coordinate gradient J = dx/dX at each quadrature point, computes
the 10-scalar qdata layout of the reference (qfunctions/common.h:47-101),
stored component-major as (10, nelem, Q3) planes:

    qdata[0]       = w * detJ
    qdata[1+3m+k] = (adj(J)/detJ)[m, k] = inv(J)[m, k] = dX_m / dx_k

Computed once at setup and reused by every residual/Jacobian/energy
application (reference src/setuplibceed.c:388-389).
"""

from __future__ import annotations

import torch


def setup_geo(dxdX: torch.Tensor, qweights: torch.Tensor) -> torch.Tensor:
    """dxdX (3, 3, nelem, Q3) with dxdX[i, j] = d x_i / d X_j, qweights (Q3,)
    -> qdata (10, nelem, Q3)."""
    J = dxdX
    # adjugate (transposed cofactor) entries, expanded as in common.h:71-79
    A = torch.stack(
        [
            J[1, 1] * J[2, 2] - J[1, 2] * J[2, 1],
            J[0, 2] * J[2, 1] - J[0, 1] * J[2, 2],
            J[0, 1] * J[1, 2] - J[0, 2] * J[1, 1],
            J[1, 2] * J[2, 0] - J[1, 0] * J[2, 2],
            J[0, 0] * J[2, 2] - J[0, 2] * J[2, 0],
            J[0, 2] * J[1, 0] - J[0, 0] * J[1, 2],
            J[1, 0] * J[2, 1] - J[1, 1] * J[2, 0],
            J[0, 1] * J[2, 0] - J[0, 0] * J[2, 1],
            J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0],
        ]
    )  # (9, nelem, Q3) row-major adj(J)
    detJ = J[0, 0] * A[0] + J[1, 0] * A[1] + J[2, 0] * A[2]
    wdetJ = qweights[None, :] * detJ
    dXdx = A / detJ
    return torch.cat([wdetJ[None], dXdx], dim=0)
