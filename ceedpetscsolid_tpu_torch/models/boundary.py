"""Dirichlet boundary conditions (reference src/boundary.c + the
DMPlexInsertBoundaryValues / constrained-DOF machinery it plugs into).
Port of ceedpetscsolid_tpu/models/boundary.py (host-side numpy).

The full nodal vector is kept with a static boolean constraint mask; BC
values (scaled by the load increment) are inserted before residual
evaluation (src/matops.c:70-73) and zeroed for Jacobian actions
(src/matops.c:104-106).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .mms import true_solution as _mms_u


def bc_mms_values(coords: np.ndarray, load_increment: float) -> np.ndarray:
    """BCMMS (boundary.c:31-45): exact MMS displacement x load increment."""
    u = _mms_u(torch.from_numpy(np.asarray(coords, np.float64))).numpy()
    return u * load_increment


def bc_clamp_values(
    coords: np.ndarray, load_increment: float, clamp_max: np.ndarray
) -> np.ndarray:
    """BCClamp (boundary.c:53-74): translate + axis-angle rotation.

    clamp_max: 7 scalars [tx, ty, tz, kx, ky, kz, theta/pi] with (kx,ky,kz)
    pre-normalized (cloptions.c:124-131).

    The u[0] expression reproduces the reference verbatim, including its
    `-ky*ky + kz*kz*x` term (boundary.c:69), which parses as
    (-ky^2) + (kz^2 * x), so clamp-driven results stay comparable.
    """
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    lx = clamp_max[0] * load_increment
    ly = clamp_max[1] * load_increment
    lz = clamp_max[2] * load_increment
    kx, ky, kz = clamp_max[3], clamp_max[4], clamp_max[5]
    theta = clamp_max[6] * np.pi * load_increment
    c, s = np.cos(theta), np.sin(theta)
    u0 = lx + s * (-kz * y + ky * z) + (1 - c) * (
        -ky * ky + kz * kz * x + kx * ky * y + kx * kz * z
    )
    u1 = ly + s * (kz * x - kx * z) + (1 - c) * (
        kx * ky * x - (kx * kx + kz * kz) * y + ky * kz * z
    )
    u2 = lz + s * (-ky * x + kx * y) + (1 - c) * (
        kx * kz * x + ky * kz * y - (kx * kx + ky * ky) * z
    )
    return np.stack([u0, u1, u2], axis=-1)


@dataclass
class BoundaryConditions:
    """Static constraint structure + load-increment-scaled value functions."""

    num_nodes: int
    # list of (node_ids, kind, payload); kind in {'mms', 'clamp'}
    entries: list = field(default_factory=list)

    def add_mms(self, node_ids: np.ndarray):
        self.entries.append((np.asarray(node_ids, np.int64), "mms", None))

    def add_clamp(self, node_ids: np.ndarray, clamp_max: np.ndarray):
        self.entries.append(
            (np.asarray(node_ids, np.int64), "clamp",
             np.asarray(clamp_max, np.float64))
        )

    def mask(self) -> np.ndarray:
        """(num_nodes, 3) bool, True where DOF is constrained."""
        m = np.zeros((self.num_nodes, 3), dtype=bool)
        for ids, _, _ in self.entries:
            m[ids, :] = True
        return m

    def values(self, coords: np.ndarray, load_increment: float) -> np.ndarray:
        """(num_nodes, 3) BC values (zeros at unconstrained DOFs)."""
        v = np.zeros((self.num_nodes, 3))
        for ids, kind, payload in self.entries:
            if kind == "mms":
                v[ids] = bc_mms_values(coords[ids], load_increment)
            else:
                v[ids] = bc_clamp_values(coords[ids], load_increment, payload)
        return v
