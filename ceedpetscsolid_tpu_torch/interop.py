"""State handed over from the JAX package, as numpy arrays, into the port's
tensors, so both packages can compute from the same state.

    qdata  (10, nelem, Q3)                    -> qdata
    stash  9 Mat3 planes (nelem, Q3), or the Pallas (9, e_pad, Q3p) array
                                              -> (9, nelem, Q3)
    u      (3, N)                             -> u
    Physics (anything with .nu and .E)        -> models.base.Physics

Nothing here imports JAX: callers convert with np.asarray first.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.base import Physics


def _tensor(a, dtype, device) -> torch.Tensor:
    """Copy (JAX hands out read-only buffers) into a contiguous tensor."""
    return torch.tensor(np.ascontiguousarray(np.asarray(a)), dtype=dtype,
                        device=device)


def qdata_from_jax(qdata, nelem: int, Q3: int, dtype=torch.float64,
                   device="cpu") -> torch.Tensor:
    """(10, nelem, Q3) qdata; a lane/row-padded Pallas view
    (10, e_pad, Q3p) is cut back to [:, :nelem, :Q3]."""
    a = np.asarray(qdata)
    if a.ndim != 3 or a.shape[0] != 10:
        raise ValueError(f"qdata must be (10, nelem, Q3), got {a.shape}")
    return _tensor(a[:, :nelem, :Q3], dtype, device)


def stash_from_jax(stash, nelem: int, Q3: int, dtype=torch.float64,
                   device="cpu") -> torch.Tensor:
    """JAX stash -> (9, nelem, Q3). Accepts the nine Mat3 planes (each
    (nelem, Q3)) or the Pallas (9, e_pad, Q3p) array, which is cut back as
    ceedpetscsolid_tpu/ops/pallas_apply.py:stash_view does."""
    planes = getattr(stash, "m", stash)
    if isinstance(planes, (list, tuple)):
        if len(planes) != 9:
            raise ValueError(f"stash needs 9 planes, got {len(planes)}")
        a = np.stack([np.asarray(p) for p in planes])
    else:
        a = np.asarray(planes)
    if a.ndim != 3 or a.shape[0] != 9:
        raise ValueError(f"stash must be (9, nelem, Q3), got {a.shape}")
    return _tensor(a[:, :nelem, :Q3], dtype, device)


def u_from_jax(u, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """(3, N) component-major L-vector."""
    a = np.asarray(u)
    if a.ndim != 2 or a.shape[0] != 3:
        raise ValueError(f"u must be (3, N), got {a.shape}")
    return _tensor(a, dtype, device)


def physics_from_jax(phys) -> Physics:
    return Physics(nu=float(phys.nu), E=float(phys.E))
