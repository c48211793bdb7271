"""A box mesh with unstructured numbering, for tests and the chip smoke run.

Takes `box_mesh`, renumbers its vertices, shuffles its elements and gives
each element a random orientation-preserving rotation of its tensor vertex
order. With `box_dims=None`, `build_fespace` takes the entity-class path
with edge/face orientation resolution (mesh/fespace.py), and with enough
elements every edge and face orientation occurs. It stands in for the
unstructured Exodus-II meshes, which are not part of the repository.
Face sets are dropped: MMS boundary conditions use the whole boundary.
"""

from __future__ import annotations

import itertools

import numpy as np

from .box import box_mesh
from .core import HexMesh


def cube_rotations() -> list[np.ndarray]:
    """The 24 rotations of the cube as signed 3x3 permutation matrices."""
    rots = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            R = np.zeros((3, 3), dtype=np.int64)
            R[np.arange(3), perm] = signs
            if round(np.linalg.det(R)) == 1:
                rots.append(R)
    return rots


def _rotation_vertex_perms() -> np.ndarray:
    """(24, 8): new local vertex v' takes old local vertex perm[v']."""
    corners = np.array([[(v >> 0) & 1, (v >> 1) & 1, (v >> 2) & 1]
                        for v in range(8)])
    centered = 2 * corners - 1
    out = []
    for R in cube_rotations():
        old = (centered @ R.T + 1) // 2            # old corner of each new one
        out.append(old[:, 0] + 2 * old[:, 1] + 4 * old[:, 2])
    return np.array(out, dtype=np.int64)


def scrambled_box_mesh(faces=(4, 4, 4), seed: int = 0) -> HexMesh:
    """Box mesh on the unit cube with shuffled vertices and elements and a
    random cube rotation of each element's local vertex order."""
    box = box_mesh(faces)
    rng = np.random.default_rng(seed)
    nv, ne = box.num_vertices, box.num_elements
    vperm = rng.permutation(nv)                  # old vertex i -> new id vperm[i]
    vertices = np.empty_like(box.vertices)
    vertices[vperm] = box.vertices
    conn = vperm[box.connectivity][rng.permutation(ne)]
    rot = _rotation_vertex_perms()[rng.integers(0, 24, size=ne)]
    conn = np.take_along_axis(conn, rot, axis=1)
    return HexMesh(vertices=vertices, connectivity=conn)
