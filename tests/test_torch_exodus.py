"""Exodus-II meshes in the port: its copies of mesh/exodus.py and
mesh/reorder.py against the JAX package's (bitwise), the invariants of
tests/test_reorder.py on the scrambled box, and a clamp solve on an Exodus
file through Config(mesh_file=...) and the CLI's -mesh against the JAX
package's (float64, CPU).

No Exodus file is part of the repository: `write_exodus` below writes HEX8
and HEX27 files of the box and of the scrambled box (a test fixture, not a
port feature), with side sets taken from the box's face sets or found by
coordinates."""

import itertools

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from ceedpetscsolid_tpu import cli as jcli
from ceedpetscsolid_tpu.mesh import exodus as jexodus
from ceedpetscsolid_tpu.mesh import reorder as jreorder
from ceedpetscsolid_tpu.parallel.partition import partition_space
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import cli as tcli
from ceedpetscsolid_tpu_torch.mesh import exodus as texodus
from ceedpetscsolid_tpu_torch.mesh import reorder as treorder
from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
from ceedpetscsolid_tpu_torch.mesh.core import (
    EXODUS_HEX8_TO_TENSOR, EXODUS_SIDE_TO_FACE, FACE_VERTICES, HexMesh)
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem

FACE_TO_SIDE = {f: s for s, f in EXODUS_SIDE_TO_FACE.items()}
# the box's face-set ids (mesh/box.py): local face f of the box lies on
# axis f // 2 at its low (even f) or high (odd f) end
BOX_FACE_IDS = {0: 6, 1: 5, 2: 3, 3: 4, 4: 1, 5: 2}


def faces_on(mesh: HexMesh, axis: int, value: float) -> np.ndarray:
    """(element, local face) pairs whose four vertices all lie on the plane
    x_axis = value."""
    on = np.isclose(mesh.vertices[:, axis], value, atol=1e-12)
    hit = on[mesh.connectivity[:, FACE_VERTICES]].all(axis=2)   # (e, 6)
    e, f = np.nonzero(hit)
    return np.stack([e, f], axis=1).astype(np.int64)


def box_face_sets(mesh: HexMesh) -> dict:
    """The unit box's six face sets, ids as mesh/box.py's, found by
    coordinates (the scrambled box carries none)."""
    return {BOX_FACE_IDS[f]: faces_on(mesh, f // 2, float(f % 2))
            for f in range(6)}


def _midpoints(mesh: HexMesh) -> np.ndarray:
    """(nelem, 19, 3): the trilinear images of the 19 points of the
    element's 3 x 3 x 3 lattice that are not corners (lattice order, not
    Exodus's HEX27 order: the reader keeps the corners only)."""
    pts = [(i, j, k) for k in range(3) for j in range(3) for i in range(3)
           if 1 in (i, j, k)]
    xe = mesh.vertices[mesh.connectivity]                       # (e, 8, 3)
    out = []
    for i, j, k in pts:
        w = np.array([(1 - i / 2 if a == 0 else i / 2)
                      * (1 - j / 2 if b == 0 else j / 2)
                      * (1 - k / 2 if c == 0 else k / 2)
                      for c in (0, 1) for b in (0, 1) for a in (0, 1)])
        out.append(np.einsum("v,evd->ed", w, xe))
    return np.stack(out, axis=1)


def write_exodus(path, mesh: HexMesh, hex27: bool, face_sets: dict,
                 seed: int = 0, coord_array: bool = False):
    """A netCDF-3 classic Exodus-II file of `mesh`: one HEX8 or HEX27 block,
    `face_sets` {id: (element, local face) pairs} as side sets. The file's
    node ids interleave the HEX27 mid-nodes with the corners (seeded), the
    corners keeping their order, so the reader's compaction has work to do
    and gives back the mesh's vertex numbering. `coord_array` writes one
    (num_dim, num_nodes) `coord` variable instead of coordx/y/z."""
    rng = np.random.default_rng(seed)
    nv, ne = mesh.num_vertices, mesh.num_elements
    nodes = mesh.connectivity[:, EXODUS_HEX8_TO_TENSOR]         # Exodus order
    coords = mesh.vertices
    if hex27:
        mids = np.arange(nv, nv + 19 * ne).reshape(ne, 19)
        nodes = np.concatenate([nodes, mids], axis=1)
        coords = np.concatenate([coords, _midpoints(mesh).reshape(-1, 3)])
    n = coords.shape[0]
    pos = rng.permutation(n)
    file_id = np.concatenate([np.sort(pos[:nv]), pos[nv:]])
    file_coords = np.empty_like(coords)
    file_coords[file_id] = coords
    nc = netcdf_file(str(path), "w")
    try:
        nc.createDimension("num_dim", 3)
        nc.createDimension("num_nodes", n)
        nc.createDimension("num_elem", ne)
        nc.createDimension("num_el_blk", 1)
        nc.createDimension("num_el_in_blk1", ne)
        nc.createDimension("num_nod_per_el1", nodes.shape[1])
        if coord_array:
            v = nc.createVariable("coord", "d", ("num_dim", "num_nodes"))
            v[:] = file_coords.T
        else:
            for d, name in enumerate(("coordx", "coordy", "coordz")):
                nc.createVariable(name, "d", ("num_nodes",))[:] = \
                    file_coords[:, d]
        blk = nc.createVariable("connect1", "i",
                                ("num_el_in_blk1", "num_nod_per_el1"))
        blk[:] = (file_id[nodes] + 1).astype(np.int32)
        blk.elem_type = "HEX27" if hex27 else "HEX8"
        if face_sets:
            nc.createDimension("num_side_sets", len(face_sets))
            ids = nc.createVariable("ss_prop1", "i", ("num_side_sets",))
            ids[:] = np.array(sorted(face_sets), dtype=np.int32)
            for i, sid in enumerate(sorted(face_sets), start=1):
                fs = face_sets[sid]
                nc.createDimension(f"num_side_ss{i}", fs.shape[0])
                nc.createVariable(f"elem_ss{i}", "i", (f"num_side_ss{i}",))[
                    :] = (fs[:, 0] + 1).astype(np.int32)
                nc.createVariable(f"side_ss{i}", "i", (f"num_side_ss{i}",))[
                    :] = np.array([FACE_TO_SIDE[int(f)] for f in fs[:, 1]],
                                  dtype=np.int32)
    finally:
        nc.close()


def _source(kind: str, n: int) -> HexMesh:
    """The box (its own face sets) or the scrambled box (face sets found by
    coordinates)."""
    if kind == "box":
        return box_mesh((n, n, n))
    m = scrambled_box_mesh((n, n, n), seed=n)
    return HexMesh(m.vertices, m.connectivity, box_face_sets(m))


def _same_mesh(a: HexMesh, b: HexMesh):
    """Bitwise: vertices, connectivity, face-set ids and pairs."""
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.connectivity, b.connectivity)
    assert a.connectivity.dtype == b.connectivity.dtype
    assert sorted(a.face_sets) == sorted(b.face_sets)
    for k in a.face_sets:
        assert np.array_equal(a.face_sets[k], b.face_sets[k])


@pytest.mark.parametrize("kind,hex27", list(itertools.product(
    ["box", "scrambled"], [False, True])))
def test_read_exodus_matches_jax(tmp_path, kind, hex27):
    """The port's reader gives what the JAX reader gives, bitwise, and both
    give back the mesh the file was written from: HEX27 files keep their
    corners only, side sets become the face sets."""
    src = _source(kind, 4)
    path = tmp_path / "m.exo"
    write_exodus(path, src, hex27, src.face_sets, seed=7,
                 coord_array=kind == "box" and not hex27)
    got = texodus.read_exodus(str(path))
    _same_mesh(got, jexodus.read_exodus(str(path)))
    assert got.connectivity.shape == (64, 8)
    np.testing.assert_array_equal(got.vertices, src.vertices)
    np.testing.assert_array_equal(got.connectivity, src.connectivity)
    for k, fs in src.face_sets.items():
        np.testing.assert_array_equal(got.face_sets[k], fs)


@pytest.mark.parametrize("kind", ["box", "scrambled"])
def test_reorder_matches_jax(kind):
    """Morton and BFS orders, the chosen order and the reordered mesh of
    every method: port and JAX agree bitwise."""
    src = _source(kind, 5)
    np.testing.assert_array_equal(treorder.morton_order(src),
                                  jreorder.morton_order(src))
    np.testing.assert_array_equal(treorder.bfs_order(src),
                                  jreorder.bfs_order(src))
    np.testing.assert_array_equal(treorder.choose_order(src),
                                  jreorder.choose_order(src))
    for method in ("auto", "sfc", "bfs"):
        _same_mesh(treorder.reorder_mesh(src, method),
                   jreorder.reorder_mesh(src, method))


def _volume(mesh: HexMesh) -> float:
    f = OperatorFactory(build_fespace(mesh, 2), dtype=torch.float64,
                        device="cpu")
    return float(f.compute_qdata()[0].sum())


def _halo(mesh: HexMesh, ndev: int = 8) -> int:
    fes = build_fespace(mesh, 2)
    return partition_space(fes.conn, fes.num_nodes,
                           ndev).halo_stats()["total_ghosts"]


def test_reorder_invariants():
    """tests/test_reorder.py's invariants on the scrambled 6^3 box: counts
    and volume kept, the connectivity a relabeling (each element's sorted
    coordinates), and each face set the same geometric faces."""
    mesh = _source("scrambled", 6)
    rmesh = treorder.reorder_mesh(mesh)
    assert rmesh.num_elements == mesh.num_elements
    assert rmesh.num_vertices == mesh.num_vertices
    assert not np.array_equal(rmesh.connectivity, mesh.connectivity)
    assert np.isclose(_volume(rmesh), _volume(mesh), rtol=1e-12)

    def elem_coord_key(m):
        c = np.sort(m.vertices[m.connectivity].reshape(m.num_elements, -1),
                    axis=1)
        return c[np.lexsort(c.T)]

    np.testing.assert_allclose(elem_coord_key(rmesh), elem_coord_key(mesh))

    def face_centroids(m, fs):
        verts = m.connectivity[fs[:, 0][:, None], FACE_VERTICES[fs[:, 1]]]
        cent = m.vertices[verts].mean(axis=1)
        return cent[np.lexsort(cent.T)]

    for k in mesh.face_sets:
        np.testing.assert_allclose(face_centroids(rmesh, rmesh.face_sets[k]),
                                   face_centroids(mesh, mesh.face_sets[k]),
                                   atol=1e-12)


def test_reorder_never_grows_halo():
    """'auto' keeps the file order unless Morton's contiguous-block halo is
    smaller: on the box (already in lattice order) and on the scrambled box
    the 8-block partition's ghosts never grow by more than the proxy/exact
    mismatch allows."""
    for kind in ("box", "scrambled"):
        mesh = _source(kind, 6)
        raw, ro = _halo(mesh), _halo(treorder.reorder_mesh(mesh))
        assert ro <= raw * 1.05 + 8, (kind, ro, raw)


def test_sfc_beats_raw_on_scrambled_mesh():
    """On the scrambled box (shuffled elements) the reordering recovers
    locality: fewer than half the raw order's ghosts."""
    mesh = _source("scrambled", 6)
    assert _halo(treorder.reorder_mesh(mesh)) < 0.5 * _halo(mesh)


CLAMP = dict(problem="hyperFS", degree=2, nu=0.3, E=1.0, forcing="none",
             bc_clamp=(998, 999), bc_clamp_translate={999: (0.02, 0.0, 0.0)},
             num_increments=1, multigrid="none")


def _clamp_file(tmp_path) -> str:
    """HEX27 file of the scrambled 3^3 box, side set 998 on x = 0 and 999
    on x = 1 (found by coordinates)."""
    m = scrambled_box_mesh((3, 3, 3), seed=3)
    path = tmp_path / "clamp.exo"
    write_exodus(path, m, True, {998: faces_on(m, 0, 0.0),
                                 999: faces_on(m, 0, 1.0)}, seed=3)
    return str(path)


def _check_u(tu, ju):
    tu, ju = tu.numpy(), np.asarray(ju)
    assert tu.shape == ju.shape
    assert np.linalg.norm(tu - ju) <= 1e-10 * np.linalg.norm(ju)


def test_clamp_solve_on_exodus_matches_jax(tmp_path):
    """hyperFS degree 2, clamped on side set 998 and translated on 999, on
    the HEX27 file through Config(mesh_file=...): the port (CPU, float64)
    reads, reorders and solves as the JAX package does: SNES and KSP
    equal, |u_port - u_jax| / |u_jax| <= 1e-10."""
    path = _clamp_file(tmp_path)
    jp = JProblem(JConfig(**CLAMP, mesh_file=path))
    tp = TProblem(TConfig(**CLAMP, mesh_file=path, device="cpu"))
    _same_mesh(tp.mesh, jp.mesh)
    ji, ti = jp.solve(), tp.solve()
    assert ji.converged and ti.converged
    assert (ti.snes_iters, ti.ksp_iters) == (ji.snes_iters, ji.ksp_iters)
    _check_u(ti.u, ji.u)


def test_cli_mesh_matches_jax(tmp_path, capsys, monkeypatch):
    """The same problem through -mesh on both CLIs (linElas, p-MG levels
    [1, 2] with the Chebyshev coarse solve): rc 0, the same summary counts,
    SNES and KSP equal, u to 1e-10, strain energy to 1e-10. (It replaces the
    -mesh case of test_torch_problem.py::test_cli_refuses_unported_options:
    the option is ported.)"""
    from ceedpetscsolid_tpu_torch.solve import cg as tcg
    from test_torch_pmg import jax_start_vector
    from test_torch_pmg_solve import _spy_solve

    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    flags = ["-mesh", _clamp_file(tmp_path), "-problem", "linElas",
             "-degree", "2", "-nu", "0.3", "-E", "1", "-bc_clamp", "998,999",
             "-bc_clamp_999_translate", "0.02,0,0", "-coarse_pc_type",
             "chebyshev"]
    got = {}
    _spy_solve(monkeypatch, JProblem, got, "j")
    _spy_solve(monkeypatch, TProblem, got, "t")
    assert jcli.main(list(flags)) == 0
    out_j = capsys.readouterr().out
    assert tcli.main(list(flags)) == 0
    out_t = capsys.readouterr().out
    (jp, ji), (tp, ti) = got["j"], got["t"]
    assert tp.level_degrees == jp.level_degrees == [1, 2]
    assert ti.converged and ji.converged
    assert (ti.snes_iters, ti.ksp_iters) == (ji.snes_iters, ji.ksp_iters)
    for line in ("SNES iterations", "KSP iterations", "Mesh:"):
        pick = [ln for ln in out_t.splitlines() if line in ln]
        assert pick and pick == [ln for ln in out_j.splitlines()
                                 if line in ln]
    _check_u(ti.u, ji.u)
    jw, tw = jp.strain_energy(ji.u), tp.strain_energy(ti.u)
    assert abs(tw - jw) <= 1e-10 * abs(jw)
