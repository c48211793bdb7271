"""Structured box hex mesh (the DMPlexCreateBoxMesh analog).

Copy of ceedpetscsolid_tpu/mesh/box.py (numpy only; see mesh/fespace.py for
why the port copies instead of importing).

Face-set numbering follows the PETSc box-mesh convention so reference
command lines translate directly (reference elasticity.c:36 uses
``-dm_plex_box_faces 3,3,3``):
    1: z=zmin   2: z=zmax   3: y=ymin   4: y=ymax   5: x=xmax   6: x=xmin
"""

from __future__ import annotations

import numpy as np

from .core import HexMesh

# PETSc box face-set id -> our local-face id (0:x- 1:x+ 2:y- 3:y+ 4:z- 5:z+)
_BOX_FACE_SET_TO_LOCAL = {1: 4, 2: 5, 3: 2, 4: 3, 5: 1, 6: 0}


def box_mesh(
    faces=(3, 3, 3),
    lower=(0.0, 0.0, 0.0),
    upper=(1.0, 1.0, 1.0),
) -> HexMesh:
    """nx x ny x nz hex box on [lower, upper] with PETSc-style face sets."""
    nx, ny, nz = (int(f) for f in faces)
    xs = np.linspace(lower[0], upper[0], nx + 1)
    ys = np.linspace(lower[1], upper[1], ny + 1)
    zs = np.linspace(lower[2], upper[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    # vertex id = i + (nx+1)*(j + (ny+1)*k): x fastest
    verts = np.stack(
        [X.transpose(2, 1, 0).ravel(), Y.transpose(2, 1, 0).ravel(),
         Z.transpose(2, 1, 0).ravel()],
        axis=1,
    )

    def vid(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    I = I.transpose(2, 1, 0).ravel()
    J = J.transpose(2, 1, 0).ravel()
    K = K.transpose(2, 1, 0).ravel()
    conn = np.stack(
        [
            vid(I, J, K), vid(I + 1, J, K), vid(I, J + 1, K), vid(I + 1, J + 1, K),
            vid(I, J, K + 1), vid(I + 1, J, K + 1), vid(I, J + 1, K + 1),
            vid(I + 1, J + 1, K + 1),
        ],
        axis=1,
    ).astype(np.int64)

    nelem = conn.shape[0]
    eid = np.arange(nelem)
    face_sets = {}
    sel = {
        1: K == 0, 2: K == nz - 1, 3: J == 0, 4: J == ny - 1,
        5: I == nx - 1, 6: I == 0,
    }
    for fs, mask in sel.items():
        es = eid[mask]
        lf = np.full(es.shape, _BOX_FACE_SET_TO_LOCAL[fs], dtype=np.int64)
        face_sets[fs] = np.stack([es, lf], axis=1)
    return HexMesh(vertices=verts, connectivity=conn, face_sets=face_sets,
                   box_dims=(nx, ny, nz))
