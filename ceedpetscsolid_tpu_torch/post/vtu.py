"""VTU output, a copy of ceedpetscsolid_tpu/post/vtu.py (reference src/misc.c:188-311,
PetscViewerVTKOpen analog).

High-order elements are written as p^3 linear hex sub-cells over the GLL
lattice — the same visual refinement PETSc's VTK viewer produces for
high-order DMPlex fields.
"""

from __future__ import annotations

import numpy as np


def _subcells(conn: np.ndarray, P: int) -> np.ndarray:
    """Split each element's lattice into (P-1)^3 hex8 cells (VTK ordering)."""
    p = P - 1
    idx = lambda i, j, k: i + P * (j + P * k)  # noqa: E731
    cells = []
    for k in range(p):
        for j in range(p):
            for i in range(p):
                cells.append(
                    [
                        idx(i, j, k), idx(i + 1, j, k), idx(i + 1, j + 1, k),
                        idx(i, j + 1, k), idx(i, j, k + 1), idx(i + 1, j, k + 1),
                        idx(i + 1, j + 1, k + 1), idx(i, j + 1, k + 1),
                    ]
                )
    sub = np.asarray(cells, dtype=np.int64)            # (p^3, 8)
    return conn[:, sub].reshape(-1, 8)                  # (nelem*p^3, 8)


def write_vtu(path: str, fes, u, diagnostics=None):
    """Write displacement (+ optional 8-component diagnostics) to `path`."""
    coords = np.asarray(fes.coords)
    u = np.asarray(u)
    if u.ndim == 2 and u.shape[0] == 3 and u.shape[1] != 3:
        u = u.T          # accept component-major (3, nnodes) device layout
    cells = _subcells(fes.conn, fes.P)
    ncell = cells.shape[0]
    npts = coords.shape[0]

    def arr(a):
        return " ".join(f"{x:.9g}" for x in np.asarray(a).ravel())

    fields = [("displacement", u, 3)]
    if diagnostics is not None:
        d = np.asarray(diagnostics)
        fields += [
            ("pressure", d[:, 3], 1),
            ("volumetric_strain", d[:, 4], 1),
            ("trace_E2", d[:, 5], 1),
            ("detJ", d[:, 6], 1),
            ("strain_energy_density", d[:, 7], 1),
        ]

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write(f'  <UnstructuredGrid><Piece NumberOfPoints="{npts}" '
                f'NumberOfCells="{ncell}">\n')
        f.write('    <Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        f.write(arr(coords) + "\n")
        f.write("    </DataArray></Points>\n")
        f.write("    <Cells>\n")
        f.write('      <DataArray type="Int64" Name="connectivity" format="ascii">\n')
        f.write(arr(cells) + "\n")
        f.write("      </DataArray>\n")
        f.write('      <DataArray type="Int64" Name="offsets" format="ascii">\n')
        f.write(arr(np.arange(1, ncell + 1) * 8) + "\n")
        f.write("      </DataArray>\n")
        f.write('      <DataArray type="UInt8" Name="types" format="ascii">\n')
        f.write(arr(np.full(ncell, 12, np.uint8)) + "\n")   # VTK_HEXAHEDRON
        f.write("      </DataArray>\n    </Cells>\n")
        f.write("    <PointData>\n")
        for name, data, ncomp in fields:
            f.write(f'      <DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            f.write(arr(data) + "\n")
            f.write("      </DataArray>\n")
        f.write("    </PointData>\n")
        f.write("  </Piece></UnstructuredGrid>\n</VTKFile>\n")
