"""The seeded box mesh that both the program and the reference are given.

A box of `faces` hexahedra on the unit cube, vertex (i, j, k) numbered
i + (nx + 1) (j + (ny + 1) k) and element (a, b, c) numbered
a + nx (b + ny c), element vertices in tensor order (local vertex
i + 2 j + 4 k): the numbering of PETSc's box mesh that the program's
`mesh/box.py` follows too (a test holds the two equal).

The seed moves every interior vertex by a uniform random fraction, at
most `amplitude`, of the element size along each axis; boundary vertices
stay put, so the box and its faces keep their shape. With amplitude below
1/4 no element folds: each vertex stays inside its own quarter cell.
The same seed gives the same mesh; every seed gives the same amount of
work (the same elements, nodes and boundary).
"""

from __future__ import annotations

import numpy as np


def box_connectivity(faces) -> np.ndarray:
    """(nelem, 8) int64 vertex ids, tensor order, x fastest."""
    nx, ny, nz = (int(f) for f in faces)
    c, b, a = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    a, b, c = a.ravel(), b.ravel(), c.ravel()

    def vid(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    return np.stack([vid(a + di, b + dj, c + dk)
                     for dk in (0, 1) for dj in (0, 1) for di in (0, 1)],
                    axis=1).astype(np.int64)


def perturbed_vertices(faces, seed: int, amplitude: float) -> np.ndarray:
    """(nverts, 3) float64 vertex coordinates of the seeded box."""
    if not 0.0 <= amplitude < 0.25:
        raise ValueError(f"amplitude {amplitude} outside [0, 0.25)")
    nx, ny, nz = (int(f) for f in faces)
    k, j, i = np.meshgrid(np.arange(nz + 1), np.arange(ny + 1),
                          np.arange(nx + 1), indexing="ij")
    ijk = np.stack([i.ravel(), j.ravel(), k.ravel()], axis=1)
    n = np.array([nx, ny, nz], dtype=np.float64)
    xyz = ijk / n
    interior = np.all((ijk > 0) & (ijk < n.astype(np.int64)), axis=1)
    rng = np.random.default_rng(int(seed))
    shift = rng.uniform(-amplitude, amplitude, size=xyz.shape) / n
    xyz[interior] += shift[interior]
    return xyz
