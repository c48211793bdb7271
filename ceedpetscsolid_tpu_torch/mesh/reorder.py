"""Locality reordering of elements and vertices (SURVEY hard part 1).

Copy of ceedpetscsolid_tpu/mesh/reorder.py (numpy only; see mesh/fespace.py
for why the port copies instead of importing);
tests/test_torch_exodus.py holds the two identical in output.

Unstructured gather/scatter cost on TPU is dominated by random HBM access
once the nodal vector exceeds on-chip memory, and contiguous-block
partitioning quality (parallel/partition.py) is set entirely by the element
order. Default ordering: MORTON space-filling curve over element centroids
— contiguous index ranges are spatially compact boxes, so per-shard halos
shrink and consecutive elements touch recently-touched nodes (the geometric
partitioning role of DMPlexDistribute's partitioner, setupdm.c:57-64; same
ordering family as p4est). A BFS (Cuthill-McKee-like) ordering over the
face-adjacency graph is kept as an alternative (better bandwidth, worse
block surface). Vertices are renumbered in first-use order; edge/face
entity ids inherit the locality automatically because fespace numbering
sorts entities by their (renumbered) vertex keys.
"""

from __future__ import annotations

import numpy as np

from .core import FACE_VERTICES, HexMesh


def morton_order(mesh: HexMesh, bits: int = 21) -> np.ndarray:
    """Element permutation by Morton (z-curve) key of element centroids."""
    cent = mesh.vertices[mesh.connectivity].mean(axis=1)      # (e, 3)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-300)
    q = ((cent - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    key = np.zeros(cent.shape[0], dtype=np.uint64)
    for b in range(bits):
        for d in range(3):
            key |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                3 * b + d)
    return np.argsort(key, kind="stable").astype(np.int64)


def element_adjacency(mesh: HexMesh):
    """Element pairs sharing a face -> CSR-ish adjacency lists."""
    conn = mesh.connectivity
    nelem = conn.shape[0]
    faces = np.sort(conn[:, FACE_VERTICES].reshape(-1, 4), axis=1)
    order = np.lexsort(faces.T)
    sf = faces[order]
    same = np.all(sf[1:] == sf[:-1], axis=1)
    e = order // 6
    a, b = e[:-1][same], e[1:][same]
    adj = [[] for _ in range(nelem)]
    for x, y in zip(a, b):
        adj[x].append(y)
        adj[y].append(x)
    return adj


def bfs_order(mesh: HexMesh) -> np.ndarray:
    """BFS element permutation over the face-adjacency graph."""
    nelem = mesh.num_elements
    adj = element_adjacency(mesh)
    visited = np.zeros(nelem, dtype=bool)
    order = []
    for seed in range(nelem):
        if visited[seed]:
            continue
        queue = [seed]
        visited[seed] = True
        while queue:
            nxt = []
            for e in queue:
                order.append(e)
                for n in adj[e]:
                    if not visited[n]:
                        visited[n] = True
                        nxt.append(n)
            queue = nxt
    return np.asarray(order, dtype=np.int64)


def block_ghost_count(conn: np.ndarray, nblocks: int) -> int:
    """Partition-quality proxy: ghost nodes of a contiguous element-block
    partition into `nblocks` (exactly what parallel/partition.py builds)."""
    nelem, P3 = conn.shape
    bsz = -(-nelem // nblocks)
    blk = np.arange(nelem) // bsz
    pairs = np.unique(
        np.stack([np.repeat(blk, P3), conn.ravel()], axis=1), axis=0)
    counts = np.bincount(pairs[:, 1])
    return int((counts[counts > 0] - 1).sum())


def choose_order(mesh: HexMesh, nblocks=(8,)) -> np.ndarray:
    """Pick the element order (file order vs Morton) with the smallest
    contiguous-block halo. Meshing tools often emit an extrusion sweep that
    is already optimal for slab blocking (all the reference cylinders are);
    Morton wins on scrambled or blob-shaped meshes. BFS is intentionally
    not a candidate: level-order shells have large block surface."""
    ident = np.arange(mesh.num_elements, dtype=np.int64)
    sfc = morton_order(mesh)
    best, best_cost = ident, None
    # default nblocks matches the primary deployment scale (8 chips/host);
    # the best order is ndev-dependent, so callers that know their device
    # count can pass it
    for perm in (ident, sfc):
        conn = mesh.connectivity[perm]
        cost = sum(block_ghost_count(conn, nb) for nb in nblocks)
        if best_cost is None or cost < best_cost:
            best, best_cost = perm, cost
    return best


def reorder_mesh(mesh: HexMesh, method: str = "auto") -> HexMesh:
    """Element reordering ('auto' picks file-order vs Morton by measured
    block-halo cost; 'sfc'/'bfs' force) + first-use vertex renumbering."""
    if method == "auto":
        perm_e = choose_order(mesh)
    elif method == "sfc":
        perm_e = morton_order(mesh)
    else:
        perm_e = bfs_order(mesh)

    conn = mesh.connectivity[perm_e]
    # vertex first-use renumbering
    nvert = mesh.num_vertices
    new_id = np.full(nvert, -1, dtype=np.int64)
    flat = conn.ravel()
    first = flat[np.sort(np.unique(flat, return_index=True)[1])]
    new_id[first] = np.arange(first.size)
    # unreferenced vertices (shouldn't exist) keep tail positions
    rest = np.where(new_id < 0)[0]
    new_id[rest] = np.arange(first.size, first.size + rest.size)
    vertices = np.empty_like(mesh.vertices)
    vertices[new_id] = mesh.vertices
    conn = new_id[conn]

    inv_e = np.empty(mesh.num_elements, dtype=np.int64)
    inv_e[perm_e] = np.arange(mesh.num_elements)
    face_sets = {
        k: np.stack([inv_e[v[:, 0]], v[:, 1]], axis=1)
        for k, v in mesh.face_sets.items()
    }
    return HexMesh(vertices=vertices, connectivity=conn, face_sets=face_sets)
