"""State handed over from the JAX package, as numpy arrays, into the port's
tensors, so both packages can compute from the same state.

    qdata  (10, nelem, Q3)                    -> qdata
    stash  9 Mat3 planes (nelem, Q3), or the Pallas (9, e_pad, Q3p) array
                                              -> (9, nelem, Q3)
    hyperFSIncomp's stash pair (mu at Q3, pressure at 1)
                                              -> (tensor, tensor)
    u      (3, N)                             -> u
    Physics (anything with .nu and .E)        -> models.base.Physics
    p-MG preconditioner data: per-level inverse diagonals (3, N_l) and
    Chebyshev bounds (lo, hi)                 -> (tensors, float pairs)
    level masks (3, N_l) bool                 -> bool tensors
    a CSR matrix (indptr, indices, data, n)   -> scipy.sparse.csr_matrix,
                                                 as AMGPreconditioner.setup
                                                 takes it

Nothing here imports JAX: callers convert with np.asarray first.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
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


def pc_from_jax(diag_invs, bounds, dtype=torch.float64, device="cpu"):
    """JAX `mg_setup` output (per-level inverse diagonals, per-level
    (lam_min, lam_max)) -> the port's (list of (3, N_l) tensors, list of
    float pairs), so a V-cycle runs on identical preconditioner data."""
    return ([u_from_jax(d, dtype, device) for d in diag_invs],
            [(float(lo), float(hi)) for lo, hi in bounds])


def mask_from_jax(mask, device="cpu") -> torch.Tensor:
    """(3, N_l) constrained-DOF mask of a level."""
    a = np.asarray(mask)
    if a.ndim != 2 or a.shape[0] != 3 or a.dtype != np.bool_:
        raise ValueError(f"mask must be (3, N) bool, got {a.shape} {a.dtype}")
    return _tensor(a, torch.bool, device)


def stash_pair_from_jax(mu, pressure, nelem: int, Q3: int,
                        dtype=torch.float64, device="cpu"):
    """hyperFSIncomp's composite stash: the mu part's (Q3 points) and the
    pressure part's (one point per element), each as stash_from_jax takes
    it (JAX's factory.stash_view / pfactory.stash_view of the pair)."""
    return (stash_from_jax(mu, nelem, Q3, dtype, device),
            stash_from_jax(pressure, nelem, 1, dtype, device))


def csr_from_jax(indptr, indices, data, n: int) -> sp.csr_matrix:
    """A CSR matrix handed over as its three arrays (e.g. the JAX package's
    CSRAssembler output), float64, for AMGPreconditioner.setup. Both
    packages run the same C++ setup, so the same CSR gives the same
    hierarchy."""
    return sp.csr_matrix((np.array(data, np.float64),
                          np.array(indices, np.int32),
                          np.array(indptr, np.int64)), shape=(n, n))
