"""Forcing-term assembly (reference qfunctions/constantForce.h,
manufacturedForce.h; operator built at src/setuplibceed.c:550-584).
Port of ceedpetscsolid_tpu/models/forcing.py.

RHS F = G^T B^T f(x_q) w detJ: pointwise force at quadrature points,
interp-transposed to nodes and scattered.
"""

from __future__ import annotations

import torch

from . import mms as mms_mod


def assemble_forcing(factory, qdata, kind: str, phys=None, forcing_vec=None):
    """Returns the nodal RHS L-vector (3, nnodes).

    kind: 'none' | 'constant' | 'mms'
    """
    restr, basis = factory.restr, factory.basis
    if kind == "none":
        return torch.zeros((3, restr.num_nodes), dtype=factory.dtype,
                           device=factory.device)
    wdetJ = qdata[0]
    if kind == "constant":
        vec = torch.as_tensor(forcing_vec, dtype=factory.dtype,
                              device=factory.device)
        fq = vec[:, None, None] * wdetJ[None]        # constantForce.h:53-66
    elif kind == "mms":
        xq = factory.quad_coords()                   # (3, nelem, Q3)
        fq = mms_mod.mms_force(xq, wdetJ, phys)
    else:
        raise ValueError(f"unknown forcing {kind!r}")
    fe = basis.apply_interp_T(fq)
    return restr.scatter_add(fe)
