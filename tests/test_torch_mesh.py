"""Mesh / FE-space parity: the port's copied numpy modules number nodes
exactly as the JAX package does, on canonical boxes (lattice path) and on
the scrambled box (entity-class path with every edge/face orientation);
and importing the port never imports JAX."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ceedpetscsolid_tpu.mesh import box as jbox, core as jcore
from ceedpetscsolid_tpu.mesh.fespace import build_fespace as jbuild
from ceedpetscsolid_tpu_torch.mesh import box as tbox, core as tcore
from ceedpetscsolid_tpu_torch.mesh.fespace import (
    _canonical_faces, build_fespace as tbuild)
from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh

REPO = Path(__file__).resolve().parents[1]


def mesh_pair(kind: str, n: int):
    """The same mesh as a JAX-package HexMesh and a port HexMesh."""
    if kind == "box":
        return jbox.box_mesh((n, n, n)), tbox.box_mesh((n, n, n))
    m = scrambled_box_mesh((n, n, n), seed=n)
    return (jcore.HexMesh(vertices=m.vertices, connectivity=m.connectivity),
            m)


@pytest.mark.parametrize("kind,n,degree", [
    ("box", 2, 2), ("box", 3, 3), ("box", 2, 4),
    ("scrambled", 3, 2), ("scrambled", 3, 3), ("scrambled", 2, 4),
])
def test_fespace_numbering_matches_jax(kind, n, degree):
    jm, tm = mesh_pair(kind, n)
    js, ts = jbuild(jm, degree), tbuild(tm, degree)
    assert ts.num_nodes == js.num_nodes
    np.testing.assert_array_equal(ts.conn, js.conn)
    np.testing.assert_array_equal(ts.coords, js.coords)
    assert (ts.off_edge, ts.off_face, ts.off_cell) == \
        (js.off_edge, js.off_face, js.off_cell)
    assert ts.lattice_dims == js.lattice_dims
    assert (ts.lattice_dims is None) == (kind == "scrambled")
    np.testing.assert_array_equal(ts.all_boundary_nodes(),
                                  js.all_boundary_nodes())
    if kind == "box":
        for fs in range(1, 7):
            np.testing.assert_array_equal(ts.face_set_nodes(fs),
                                          js.face_set_nodes(fs))


def test_scrambled_box_has_every_orientation():
    """All 8 face orientation cases and both edge directions occur, so the
    entity-class numbering's orientation resolution is fully exercised."""
    m = scrambled_box_mesh((3, 3, 3), seed=3)
    _, r, fwd = _canonical_faces(m.connectivity[:, tcore.FACE_VERTICES])
    assert len(set(zip(r.ravel().tolist(), fwd.ravel().tolist()))) == 8
    ev = m.connectivity[:, tcore.EDGE_VERTICES]
    assert set((ev[:, :, 0] > ev[:, :, 1]).ravel().tolist()) == {False, True}
    # every element keeps a positive volume (orientation-preserving)
    x = m.vertices[m.connectivity]                      # (e, 8, 3)
    J = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0], x[:, 4] - x[:, 0]],
                 axis=-1)
    assert (np.linalg.det(J) > 0).all()


def test_port_import_leaves_jax_out():
    code = ("import sys\n"
            "import ceedpetscsolid_tpu_torch, ceedpetscsolid_tpu_torch.cli, "
            "ceedpetscsolid_tpu_torch.problem, "
            "ceedpetscsolid_tpu_torch.ops.fused_apply, "
            "ceedpetscsolid_tpu_torch.interop\n"
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'ceedpetscsolid_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
