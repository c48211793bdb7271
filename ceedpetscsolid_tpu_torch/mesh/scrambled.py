"""A box mesh with unstructured numbering, for tests and the chip smoke run.

Takes `box_mesh`, renumbers its vertices, shuffles its elements and gives
each element a random orientation-preserving rotation of its tensor vertex
order. With `box_dims=None`, `build_fespace` takes the entity-class path
with edge/face orientation resolution (mesh/fespace.py), and with enough
elements every edge and face orientation occurs. It stands in for the
unstructured Exodus-II meshes, which are not part of the repository.
Face sets are dropped: MMS boundary conditions use the whole boundary.
`write_exodus_hex27` writes such a mesh as an Exodus-II file, with the face
sets a caller names (`faces_on`), for the paths that read a file.
"""

from __future__ import annotations

import itertools

import numpy as np

from .box import box_mesh
from .core import (
    EXODUS_HEX8_TO_TENSOR,
    EXODUS_SIDE_TO_FACE,
    FACE_VERTICES,
    HexMesh,
)


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


def write_exodus_hex27(path, mesh, side_sets):
    """A netCDF-3 classic Exodus-II file of `mesh`, one HEX27 block (the 19
    higher-order nodes of each element at its lattice midpoints, numbered
    after the corners; the reader keeps the corners only) and `side_sets`
    {id: (element, local face) pairs}."""
    from scipy.io import netcdf_file

    side = {f: s for s, f in EXODUS_SIDE_TO_FACE.items()}
    nv, ne = mesh.num_vertices, mesh.num_elements
    xe = mesh.vertices[mesh.connectivity]                    # (e, 8, 3)
    mids = []
    for k, j, i in np.ndindex(3, 3, 3):
        if 1 not in (i, j, k):
            continue
        w = np.array([(i / 2 if a else 1 - i / 2) * (j / 2 if b else 1 - j / 2)
                      * (k / 2 if c else 1 - k / 2)
                      for c in (0, 1) for b in (0, 1) for a in (0, 1)])
        mids.append(np.einsum("v,evd->ed", w, xe))
    coords = np.concatenate([mesh.vertices,
                             np.stack(mids, axis=1).reshape(-1, 3)])
    nodes = np.concatenate([mesh.connectivity[:, EXODUS_HEX8_TO_TENSOR],
                            np.arange(nv, nv + 19 * ne).reshape(ne, 19)], 1)
    nc = netcdf_file(str(path), "w")
    try:
        for name, n in (("num_dim", 3), ("num_nodes", coords.shape[0]),
                        ("num_elem", ne), ("num_el_blk", 1),
                        ("num_el_in_blk1", ne), ("num_nod_per_el1", 27),
                        ("num_side_sets", len(side_sets))):
            nc.createDimension(name, n)
        for d, name in enumerate(("coordx", "coordy", "coordz")):
            nc.createVariable(name, "d", ("num_nodes",))[:] = coords[:, d]
        blk = nc.createVariable("connect1", "i",
                                ("num_el_in_blk1", "num_nod_per_el1"))
        blk[:] = (nodes + 1).astype(np.int32)
        blk.elem_type = "HEX27"
        nc.createVariable("ss_prop1", "i", ("num_side_sets",))[:] = \
            np.array(sorted(side_sets), dtype=np.int32)
        for i, sid in enumerate(sorted(side_sets), start=1):
            fs = side_sets[sid]
            nc.createDimension(f"num_side_ss{i}", fs.shape[0])
            nc.createVariable(f"elem_ss{i}", "i", (f"num_side_ss{i}",))[:] = \
                (fs[:, 0] + 1).astype(np.int32)
            nc.createVariable(f"side_ss{i}", "i", (f"num_side_ss{i}",))[:] = \
                np.array([side[int(f)] for f in fs[:, 1]], dtype=np.int32)
    finally:
        nc.close()


def faces_on(mesh, axis, value):
    """(element, local face) pairs of `mesh` on the plane x_axis = value."""
    on = np.isclose(mesh.vertices[:, axis], value, atol=1e-12)
    e, f = np.nonzero(on[mesh.connectivity[:, FACE_VERTICES]].all(axis=2))
    return np.stack([e, f], axis=1).astype(np.int64)
