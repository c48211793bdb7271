"""Per-degree H1 Lagrange finite-element space on a hex mesh.

Copy of ceedpetscsolid_tpu/mesh/fespace.py (numpy only). It is copied, not
imported, because importing any ceedpetscsolid_tpu submodule runs that
package's __init__, which imports JAX; the node numbering must stay
identical to the JAX package's (tests/test_torch_mesh.py checks it). The
port takes the explicit `conn` path for lattice-numbered box spaces too;
`lattice_dims` is informational here.

Builds the global DOF numbering and the tensor-ordered element connectivity
that the matrix-free operator pipeline consumes. This is the framework-owned
equivalent of PETSc's section/closure machinery with
DMPlexSetClosurePermutationTensor applied (reference src/setupdm.c:138-201):
element DOFs come out in lattice order (x fastest), nodes sit at the
Gauss-Lobatto points of each element, and continuity across shared
vertices/edges/faces is enforced by entity-based numbering with explicit
edge/face orientation resolution.

Scalar DOF numbering: [vertices | edge nodes | face nodes | cell interiors].
Vector fields store components interlaced at use time as (nnodes, ncomp)
arrays (the analog of libCEED's interlaced restriction,
reference src/setuplibceed.c:235-236).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ..ops import quadrature
from .core import EDGE_VERTICES, FACE_VERTICES, HexMesh


def _face_param_axes(p: int):
    """Per local face: lattice coords (u, v) for each face lattice point.

    Returns list of 6 callables mapping (i, j, k) -> (u, v) consistent with
    the cyclic corner order in FACE_VERTICES (corner 0 at (0,0), corner 1 at
    (p,0), corner 2 at (p,p), corner 3 at (0,p)).
    """
    return [
        lambda i, j, k: (j, k),  # x=0 face, verts [0,2,6,4]
        lambda i, j, k: (j, k),  # x=1 face, verts [1,3,7,5]
        lambda i, j, k: (i, k),  # y=0 face, verts [0,1,5,4]
        lambda i, j, k: (i, k),  # y=1 face, verts [2,3,7,6]
        lambda i, j, k: (i, j),  # z=0 face, verts [0,1,3,2]
        lambda i, j, k: (i, j),  # z=1 face, verts [4,5,7,6]
    ]


def _canonical_faces(elem_faces: np.ndarray):
    """Canonicalize cyclic quad corner lists.

    elem_faces: (nelem, 6, 4) global vertex ids in cyclic order.
    Returns (keys (nelem,6,4) canonical cyclic tuples, r (nelem,6) rotation,
    fwd (nelem,6) bool: canonical traversal follows local cyclic direction).
    """
    r = np.argmin(elem_faces, axis=2)                      # (nelem, 6)
    n0, n1, n2, n3 = (np.take_along_axis(elem_faces, ((r + s) % 4)[..., None], axis=2)[..., 0]
                      for s in range(4))
    fwd = n1 < n3                                          # next neighbor smaller -> forward
    keys = np.where(
        fwd[..., None],
        np.stack([n0, n1, n2, n3], axis=-1),
        np.stack([n0, n3, n2, n1], axis=-1),
    )
    return keys, r, fwd


def _face_slot(u, v, p, r, fwd):
    """Map local face lattice coords (u,v) to canonical slot index.

    u, v: arrays in 1..p-1 (face-interior lattice coords, element-local).
    r, fwd: per-(element,face) canonical rotation/direction.
    Returns slot = (t'-1)*(p-1) + (s'-1) in the face's canonical frame.
    """
    # 8 symmetry cases of the square (see derivation in fespace docs)
    s_fwd = [u, v, p - u, p - v]
    t_fwd = [v, p - u, p - v, u]
    s_bwd = [v, p - u, p - v, u]
    t_bwd = [u, v, p - u, p - v]
    sp = np.where(fwd, np.choose(r, s_fwd), np.choose(r, s_bwd))
    tp = np.where(fwd, np.choose(r, t_fwd), np.choose(r, t_bwd))
    return (tp - 1) * (p - 1) + (sp - 1)


@dataclass
class FESpace:
    """Degree-p H1 Lagrange space over a hex mesh (scalar layout)."""

    mesh: HexMesh
    degree: int
    num_nodes: int
    conn: np.ndarray          # (nelem, P^3) int32, lattice order, x fastest
    coords: np.ndarray        # (num_nodes, 3) nodal coordinates (GLL lattice)
    # entity-class node-id boundaries: [0, off_edge) vertices,
    # [off_edge, off_face) edge nodes, [off_face, off_cell) face nodes,
    # [off_cell, num_nodes) cell interiors -- drives the multiplicity-
    # stratified scatter (ops/restriction.py)
    off_edge: int = 0
    off_face: int = 0
    off_cell: int = 0
    # (nx, ny, nz) iff numbered in LATTICE order over a canonical box mesh
    # (node (i,j,k) -> i + Nx*(j + Ny*k)); enables ops/lattice.py. The
    # entity-class offsets above are meaningless in that case.
    lattice_dims: tuple | None = None
    _bnodes_cache: dict = field(default_factory=dict, repr=False)

    def entity_node_ranges(self) -> list:
        """Contiguous node-id ranges of ~uniform multiplicity."""
        if self.lattice_dims is not None:
            return [(0, self.num_nodes)]
        return [
            (0, self.off_edge),
            (self.off_edge, self.off_face),
            (self.off_face, self.off_cell),
            (self.off_cell, self.num_nodes),
        ]

    @property
    def P(self) -> int:
        return self.degree + 1

    @property
    def num_elements(self) -> int:
        return self.conn.shape[0]

    def multiplicity(self) -> np.ndarray:
        """Per-node element-sharing count (CeedElemRestrictionGetMultiplicity
        analog, reference src/misc.c:115-143)."""
        return np.bincount(self.conn.ravel(), minlength=self.num_nodes).astype(np.float64)

    # -- boundary node queries -------------------------------------------
    def face_lattice_indices(self, local_face: int) -> np.ndarray:
        """Flat lattice indices of the P^2 points on a local face."""
        P = self.P
        i, j, k = np.meshgrid(np.arange(P), np.arange(P), np.arange(P), indexing="ij")
        sel = [i == 0, i == P - 1, j == 0, j == P - 1, k == 0, k == P - 1][local_face]
        flat = (i + P * (j + P * k))[sel]
        return flat.ravel()

    def boundary_nodes(self, face_pairs: np.ndarray) -> np.ndarray:
        """Unique node ids on the given (element, local face) pairs."""
        out = []
        for lf in range(6):
            es = face_pairs[face_pairs[:, 1] == lf, 0]
            if es.size:
                out.append(self.conn[np.ix_(es, self.face_lattice_indices(lf))].ravel())
        if not out:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(out))

    def face_set_nodes(self, face_set_id: int) -> np.ndarray:
        if face_set_id not in self._bnodes_cache:
            if face_set_id not in self.mesh.face_sets:
                raise KeyError(
                    f"face set {face_set_id} not in mesh (available: "
                    f"{sorted(self.mesh.face_sets)}). Note: *_ns meshes "
                    "carry node sets, not sidesets; like the reference "
                    "(DMAddBoundary on 'Face Sets', setupdm.c:176-187), "
                    "-bc_clamp requires sideset (*_ss) meshes."
                )
            self._bnodes_cache[face_set_id] = self.boundary_nodes(
                self.mesh.face_sets[face_set_id]
            )
        return self._bnodes_cache[face_set_id]

    def all_boundary_nodes(self) -> np.ndarray:
        """Nodes on the whole exterior boundary ('marker' label analog)."""
        if "all" not in self._bnodes_cache:
            self._bnodes_cache["all"] = self.boundary_nodes(self.mesh.boundary_faces())
        return self._bnodes_cache["all"]


def _is_canonical_box(mesh: HexMesh) -> bool:
    """True iff the mesh is a box mesh in canonical lattice vertex numbering
    and lattice element order (as produced by mesh/box.py, unpermuted)."""
    if mesh.box_dims is None:
        return False
    nx, ny, nz = mesh.box_dims
    if (mesh.num_elements != nx * ny * nz
            or mesh.num_vertices != (nx + 1) * (ny + 1) * (nz + 1)):
        return False
    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I = I.transpose(2, 1, 0).ravel()
    J = J.transpose(2, 1, 0).ravel()
    K = K.transpose(2, 1, 0).ravel()

    def vid(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    expect = np.stack(
        [vid(I, J, K), vid(I + 1, J, K), vid(I, J + 1, K),
         vid(I + 1, J + 1, K), vid(I, J, K + 1), vid(I + 1, J, K + 1),
         vid(I, J + 1, K + 1), vid(I + 1, J + 1, K + 1)], axis=1)
    return np.array_equal(np.asarray(mesh.connectivity), expect)


def _build_lattice_fespace(mesh: HexMesh, p: int) -> FESpace:
    """Lattice-numbered degree-p space on a canonical box mesh.

    Node (i, j, k) -> i + Nx*(j + Ny*k); element connectivity windows are
    implicit, which lets the operator pipeline use the index-free
    structured restriction (ops/lattice.py). Explicit conn is still built
    (numpy, setup time) for the generic consumers (qdata-independent paths,
    CSR assembly, partitioning).
    """
    nx, ny, nz = mesh.box_dims
    P = p + 1
    Nx, Ny, Nz = p * nx + 1, p * ny + 1, p * nz + 1
    num_nodes = Nx * Ny * Nz

    # element lattice coords, x fastest (matches box_mesh element order)
    A, B, C = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    ea = A.transpose(2, 1, 0).ravel()
    eb = B.transpose(2, 1, 0).ravel()
    ec = C.transpose(2, 1, 0).ravel()
    # local lattice offsets, x fastest (t = i + P*(j + P*k))
    li, lj, lk = _lattice_grids(P)
    li = li.transpose(2, 1, 0).ravel()
    lj = lj.transpose(2, 1, 0).ravel()
    lk = lk.transpose(2, 1, 0).ravel()
    gi = p * ea[:, None] + li[None, :]
    gj = p * eb[:, None] + lj[None, :]
    gk = p * ec[:, None] + lk[None, :]
    conn = gi + Nx * (gj + Ny * gk)

    # nodal coordinates: trilinear geometry at the GLL lattice (identical
    # formula to the generic path below)
    g, _ = quadrature.gauss_lobatto(P) if P > 1 else (np.zeros(1), None)
    t = (g + 1.0) / 2.0
    wx = np.stack([1.0 - t, t])
    W = np.einsum("ai,bj,ck->ijkabc", wx, wx, wx).reshape(P ** 3, 8)
    vcoords = mesh.vertices[mesh.connectivity]          # (nelem, 8, 3)
    lattice_xyz = np.einsum("la,ead->eld", W, vcoords)
    coords = np.empty((num_nodes, 3))
    coords[conn.ravel()] = lattice_xyz.reshape(-1, 3)

    return FESpace(
        mesh=mesh, degree=p, num_nodes=num_nodes,
        conn=conn.astype(np.int32), coords=coords,
        lattice_dims=(nx, ny, nz),
    )


def build_fespace(mesh: HexMesh, degree: int) -> FESpace:
    """Build the degree-p space: global numbering + tensor connectivity.

    Canonical box meshes get LATTICE numbering (node (i,j,k) lexicographic)
    so the operator pipeline can use the index-free structured restriction;
    everything else gets entity-class numbering with orientation resolution.
    """
    p = int(degree)
    if p < 1:
        raise ValueError("degree must be >= 1")
    if _is_canonical_box(mesh):
        return _build_lattice_fespace(mesh, p)
    P = p + 1
    conn8 = mesh.connectivity
    nelem, nverts = conn8.shape[0], mesh.num_vertices

    # ---- entity numbering ------------------------------------------------
    if p > 1:
        elem_edges = conn8[:, EDGE_VERTICES]                       # (nelem, 12, 2)
        edge_keys = np.sort(elem_edges, axis=2).reshape(-1, 2)
        uk, edge_ids_flat = np.unique(edge_keys, axis=0, return_inverse=True)
        nedges = uk.shape[0]
        edge_ids = edge_ids_flat.reshape(nelem, 12)
        edge_flip = elem_edges[:, :, 0] > elem_edges[:, :, 1]      # local dir reversed

        elem_faces = conn8[:, FACE_VERTICES]                       # (nelem, 6, 4)
        fkeys, f_r, f_fwd = _canonical_faces(elem_faces)
        ufk, face_ids_flat = np.unique(fkeys.reshape(-1, 4), axis=0, return_inverse=True)
        nfaces = ufk.shape[0]
        face_ids = face_ids_flat.reshape(nelem, 6)
    else:
        nedges = nfaces = 0

    n_edge_dofs = nedges * (p - 1)
    n_face_dofs = nfaces * (p - 1) ** 2
    n_cell_dofs = nelem * (p - 1) ** 3
    off_e = nverts
    off_f = off_e + n_edge_dofs
    off_c = off_f + n_face_dofs
    num_nodes = off_c + n_cell_dofs

    # ---- element connectivity in lattice order ---------------------------
    conn = np.empty((nelem, P ** 3), dtype=np.int64)
    interior = lambda t: (t > 0) & (t < p)  # noqa: E731

    # Edge slot lookup: direction-major as in core.EDGE_VERTICES
    for k in range(P):
        for j in range(P):
            for i in range(P):
                flat = i + P * (j + P * k)
                ii, jj, kk = interior(i), interior(j), interior(k)
                n_int = int(ii) + int(jj) + int(kk)
                if n_int == 0:
                    v = (i == p) * 1 + (j == p) * 2 + (k == p) * 4
                    conn[:, flat] = conn8[:, v]
                elif n_int == 1:
                    if ii:
                        slot12, t = (j == p) * 1 + (k == p) * 2, i
                    elif jj:
                        slot12, t = 4 + (i == p) * 1 + (k == p) * 2, j
                    else:
                        slot12, t = 8 + (i == p) * 1 + (j == p) * 2, k
                    eids = edge_ids[:, slot12]
                    tloc = np.where(edge_flip[:, slot12], p - t, t)
                    conn[:, flat] = off_e + eids * (p - 1) + (tloc - 1)
                elif n_int == 2:
                    if not ii:
                        lf, (u, v) = (0 if i == 0 else 1), (j, k)
                    elif not jj:
                        lf, (u, v) = (2 if j == 0 else 3), (i, k)
                    else:
                        lf, (u, v) = (4 if k == 0 else 5), (i, j)
                    fids = face_ids[:, lf]
                    slot = _face_slot(
                        np.full(nelem, u), np.full(nelem, v), p,
                        f_r[:, lf], f_fwd[:, lf],
                    )
                    conn[:, flat] = off_f + fids * (p - 1) ** 2 + slot
                else:
                    slot = (i - 1) + (p - 1) * ((j - 1) + (p - 1) * (k - 1))
                    conn[:, flat] = off_c + np.arange(nelem) * (p - 1) ** 3 + slot

    # ---- nodal coordinates (trilinear geometry at GLL lattice points) ----
    # Geometry is always trilinear from the 8 vertices, matching the
    # reference's 2-point coordinate basis (src/setuplibceed.c:339).
    g, _ = quadrature.gauss_lobatto(P) if P > 1 else (np.zeros(1), None)
    t = (g + 1.0) / 2.0                                           # [0,1]
    w0, w1 = 1.0 - t, t
    # trilinear weights for the 8 tensor-order vertices at each lattice point
    wx = np.stack([w0, w1])                                       # (2, P)
    W = np.einsum("ai,bj,ck->ijkabc", wx, wx, wx).reshape(P ** 3, 8)
    vcoords = mesh.vertices[conn8]                                # (nelem, 8, 3)
    lattice_xyz = np.einsum("la,ead->eld", W, vcoords)            # (nelem, P3, 3)
    coords = np.empty((num_nodes, 3))
    coords[conn.ravel()] = lattice_xyz.reshape(-1, 3)             # shared nodes agree

    return FESpace(
        mesh=mesh, degree=p, num_nodes=num_nodes,
        conn=conn.astype(np.int32), coords=coords,
        off_edge=off_e, off_face=off_f, off_cell=off_c,
    )


@lru_cache(maxsize=None)
def _lattice_grids(P: int):
    i, j, k = np.meshgrid(np.arange(P), np.arange(P), np.arange(P), indexing="ij")
    return i, j, k
