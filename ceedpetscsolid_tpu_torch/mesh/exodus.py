"""Exodus-II mesh ingestion (the DMPlexCreateFromFile analog,
reference src/setupdm.c:49-55).

Copy of ceedpetscsolid_tpu/mesh/exodus.py (numpy and scipy only; see
mesh/fespace.py for why the port copies instead of importing);
tests/test_torch_exodus.py holds the two identical in output.

Exodus-II files are netCDF classic files; read host-side via
scipy.io.netcdf_file (no external mesh libraries). Supports HEX8 and HEX27
blocks; like PETSc's Exodus reader path used by the reference (which builds
a 2-node-per-dim coordinate basis, src/setuplibceed.c:339), only the 8
corner vertices define the geometry — HEX27 mid-nodes are dropped and the
vertex numbering is compacted.

Sidesets become face sets: (element, local face) pairs via the standard
Exodus HEX side numbering (mesh/core.py EXODUS_SIDE_TO_FACE).

Node sets (*_ns meshes) are intentionally NOT mapped to BC sets: the
reference registers essential BCs only on the "Face Sets" label
(DMAddBoundary, src/setupdm.c:176-187), so node-set meshes are not usable
with -bc_clamp there either. HDF5-based Exodus files are not supported
(netCDF-3 classic only); convert with `ncks -3` if needed.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from .core import EXODUS_HEX8_TO_TENSOR, EXODUS_SIDE_TO_FACE, HexMesh


def read_exodus(path: str) -> HexMesh:
    try:
        nc = netcdf_file(path, "r", mmap=False)
    except Exception as e:
        raise ValueError(
            f"cannot read {path} as netCDF-3 classic Exodus ({e}). "
            "HDF5-based Exodus files are not supported — convert with "
            "`ncks -3 in.exo out.exo` (NCO) or "
            "`nccopy -k classic in.exo out.exo`."
        ) from e
    try:
        dims = nc.dimensions
        nblk = int(dims.get("num_el_blk", 1))

        # --- coordinates ------------------------------------------------
        if "coord" in nc.variables:
            coords = np.array(nc.variables["coord"][:], dtype=np.float64).T
        else:
            coords = np.stack(
                [
                    np.array(nc.variables["coordx"][:], dtype=np.float64),
                    np.array(nc.variables["coordy"][:], dtype=np.float64),
                    np.array(nc.variables["coordz"][:], dtype=np.float64),
                ],
                axis=1,
            )

        # --- element blocks (concatenated, corner vertices only) ---------
        conn_blocks = []
        for b in range(1, nblk + 1):
            cb = np.array(nc.variables[f"connect{b}"][:], dtype=np.int64)
            if cb.shape[1] not in (8, 27):
                raise ValueError(
                    f"unsupported element with {cb.shape[1]} nodes in {path}"
                )
            conn_blocks.append(cb[:, :8] - 1)        # corners, 0-based
        conn_exo = np.concatenate(conn_blocks, axis=0)

        # compact vertex numbering (drop HEX27 mid-nodes)
        used = np.unique(conn_exo)
        remap = np.full(coords.shape[0], -1, dtype=np.int64)
        remap[used] = np.arange(used.size)
        vertices = coords[used]
        conn = remap[conn_exo][:, EXODUS_HEX8_TO_TENSOR]

        # --- sidesets -> face sets ---------------------------------------
        face_sets = {}
        nss = int(dims.get("num_side_sets", 0) or 0)
        ss_ids = (
            np.array(nc.variables["ss_prop1"][:], dtype=np.int64)
            if "ss_prop1" in nc.variables
            else np.arange(1, nss + 1)
        )
        for i in range(nss):
            elems = np.array(nc.variables[f"elem_ss{i + 1}"][:], dtype=np.int64) - 1
            sides = np.array(nc.variables[f"side_ss{i + 1}"][:], dtype=np.int64)
            local = np.array([EXODUS_SIDE_TO_FACE[int(s)] for s in sides],
                             dtype=np.int64)
            face_sets[int(ss_ids[i])] = np.stack([elems, local], axis=1)

        return HexMesh(vertices=vertices, connectivity=conn, face_sets=face_sets)
    finally:
        nc.close()
