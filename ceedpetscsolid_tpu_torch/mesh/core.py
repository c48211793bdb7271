"""Hexahedral mesh container and local numbering conventions.

Copy of ceedpetscsolid_tpu/mesh/core.py (numpy only; see mesh/fespace.py
for why the port copies instead of importing).

The framework-internal hex vertex numbering is *tensor order*: vertex
(i, j, k) in {0,1}^3 has local id i + 2j + 4k. Exodus-II HEX8 connectivity
is permuted into this order at ingest (see mesh/exodus.py).

Local face ids: 0: x=0, 1: x=1, 2: y=0, 3: y=1, 4: z=0, 5: z=1.

Reference parity: the mesh + face-set role of PETSc DMPlex
(reference src/setupdm.c:40-68); face sets carry Dirichlet BC labels
(setupdm.c:158-193).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Local vertex ids (tensor order) of each local face, in cyclic order around
# the quad (consistent right-handed walk when viewed from outside is not
# required -- only cyclic adjacency matters for orientation resolution).
# Vertex id = i + 2j + 4k.
FACE_VERTICES = np.array(
    [
        [0, 2, 6, 4],  # x = 0
        [1, 3, 7, 5],  # x = 1
        [0, 1, 5, 4],  # y = 0
        [2, 3, 7, 6],  # y = 1
        [0, 1, 3, 2],  # z = 0
        [4, 5, 7, 6],  # z = 1
    ],
    dtype=np.int64,
)

# 12 edges of the hex as (vertex a, vertex b) in tensor order.
# Order: 4 x-direction edges (j,k) = (0,0),(1,0),(0,1),(1,1), then 4 y-dir,
# then 4 z-dir.
EDGE_VERTICES = np.array(
    [
        [0, 1], [2, 3], [4, 5], [6, 7],  # x edges
        [0, 2], [1, 3], [4, 6], [5, 7],  # y edges
        [0, 4], [1, 5], [2, 6], [3, 7],  # z edges
    ],
    dtype=np.int64,
)

# Exodus-II HEX8 -> tensor-order permutation: tensor_conn = exo_conn[:, perm]
EXODUS_HEX8_TO_TENSOR = np.array([0, 1, 3, 2, 4, 5, 7, 6], dtype=np.int64)

# Exodus-II HEX side number (1-based) -> local face id (our convention).
# Exodus sides: 1:{1,2,6,5} y=0 | 2:{2,3,7,6} x=1 | 3:{3,4,8,7} y=1
#               4:{1,5,8,4} x=0 | 5:{1,4,3,2} z=0 | 6:{5,6,7,8} z=1
EXODUS_SIDE_TO_FACE = {1: 2, 2: 1, 3: 3, 4: 0, 5: 4, 6: 5}


@dataclass
class HexMesh:
    """Unstructured hex mesh: vertex coords + hex8 connectivity (tensor order).

    face_sets maps a face-set id to an (n, 2) int array of
    (element id, local face id) pairs.
    """

    vertices: np.ndarray                     # (nverts, 3) float64
    connectivity: np.ndarray                 # (nelem, 8) int64, tensor order
    face_sets: dict = field(default_factory=dict)
    # (nx, ny, nz) element counts iff generated as a canonical box mesh
    # (lattice vertex numbering, lattice element order) -- enables the
    # index-free structured restriction (ops/lattice.py). None otherwise.
    box_dims: tuple | None = None

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_elements(self) -> int:
        return self.connectivity.shape[0]

    def boundary_faces(self) -> np.ndarray:
        """All exterior faces as (n, 2) (element, local face) pairs.

        A face is exterior iff it appears in exactly one element. This is the
        analog of DMPlex's all-boundary 'marker' label used in test mode
        (reference src/setupdm.c:160-170).
        """
        nelem = self.num_elements
        elem_faces = self.connectivity[:, FACE_VERTICES]          # (nelem, 6, 4)
        keys = np.sort(elem_faces.reshape(-1, 4), axis=1)          # canonical key
        _, inverse, counts = np.unique(
            keys, axis=0, return_inverse=True, return_counts=True
        )
        exterior = counts[inverse] == 1                            # (nelem*6,)
        idx = np.nonzero(exterior)[0]
        return np.stack([idx // 6, idx % 6], axis=1).astype(np.int64)
