"""Post-processing in the port against the JAX package (float64, CPU): the
models' diagnostic_qf, ElasticityProblem.diagnostics on the same u, the
copy of post/vtu.py (its source, and byte-identical files from the same
arrays), and the CLI's -view_soln / -view_final_soln files."""

import xml.etree.ElementTree as ET
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu import cli as jcli
from ceedpetscsolid_tpu.mesh import box as jbox
from ceedpetscsolid_tpu.mesh import core as jcore
from ceedpetscsolid_tpu.mesh.fespace import build_fespace as jbuild
from ceedpetscsolid_tpu.models import Physics as JPhysics
from ceedpetscsolid_tpu.models import get_model as jget_model
from ceedpetscsolid_tpu.post import vtu as jvtu
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import cli as tcli
from ceedpetscsolid_tpu_torch import interop
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace as tbuild
from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh
from ceedpetscsolid_tpu_torch.models import get_model as tget_model
from ceedpetscsolid_tpu_torch.post import vtu as tvtu
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem

REPO = Path(__file__).resolve().parents[1]
JPHYS = JPhysics(nu=0.3, E=1.0)
TPHYS = interop.physics_from_jax(JPHYS)
# a clamp in two increments: solution-001.vtu, solution-002.vtu
CLAMP_FLAGS = ["-problem", "hyperFS", "-degree", "2", "-nu", "0.3", "-E", "1",
               "-dm_plex_box_faces", "2,2,2", "-multigrid", "none",
               "-num_steps", "2", "-bc_clamp", "6,5",
               "-bc_clamp_5_translate", "0.05,0,0"]


def _planes_close(got, ref, rtol):
    """Each plane (leading axis) to rtol of that plane's max |value|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= rtol * max(np.abs(r).max(), 1e-300)


@pytest.mark.parametrize("name", ["linElas", "hyperSS", "hyperFS",
                                  "hyperFSIncomp"])
def test_diagnostic_qf_matches_jax(name):
    """Random gradients at small strain (~1e-2) and a perturbed geometry:
    all 8 planes to 1e-13 of each plane's max |value| (only the summation
    order differs)."""
    rng = np.random.default_rng(11)
    b = (5, 7)
    u = rng.normal(size=(3, *b)) * 1e-2
    du = rng.normal(size=(3, 3, *b)) * 1e-2
    qd = np.concatenate([rng.uniform(0.5, 1.5, size=(1, *b)),
                         (np.eye(3).reshape(9, 1, 1)
                          + 0.1 * rng.normal(size=(9, *b)))])
    ref = jget_model(name).diagnostic_qf(jnp.asarray(u), jnp.asarray(du),
                                         jnp.asarray(qd), JPHYS)
    got = tget_model(name).diagnostic_qf(torch.as_tensor(u),
                                         torch.as_tensor(du),
                                         torch.as_tensor(qd), TPHYS)
    assert got.shape == (8, *b) and got.dtype == torch.float64
    _planes_close(got, ref, 1e-13)


def _problems(kind, problem):
    """A JAX and a port problem on the same 2^3 degree-2 mesh (-test: MMS
    boundary conditions on the whole boundary, which the scrambled box,
    having no face sets, needs)."""
    kw = dict(problem=problem, degree=2, nu=0.3, E=1.0, test_mode=True,
              box_faces=(2, 2, 2), multigrid="none", num_increments=1)
    if kind == "box":
        jm, tm = jbox.box_mesh((2, 2, 2)), None
    else:
        tm = scrambled_box_mesh((2, 2, 2), seed=2)
        jm = jcore.HexMesh(vertices=tm.vertices, connectivity=tm.connectivity)
    return (JProblem(JConfig(**kw), mesh=jm),
            TProblem(TConfig(**kw, device="cpu"), mesh=tm))


@pytest.mark.parametrize("kind,problem", [("box", "linElas"),
                                          ("box", "hyperFS"),
                                          ("scrambled", "hyperFS")])
def test_diagnostics_match_jax(kind, problem):
    """The same u (small strain, from a seed) through both packages'
    ElasticityProblem.diagnostics: (nnodes, 8) float64, every column to
    1e-12 of its max |value|; columns 0-2 are u itself to 1e-15."""
    jp, tp = _problems(kind, problem)
    rng = np.random.default_rng(5)
    u_j = jnp.asarray(rng.normal(size=(3, tp.fine_space.num_nodes)) * 1e-2)
    ref = np.asarray(jp.diagnostics(u_j))
    u = interop.u_from_jax(u_j, device="cpu")
    got = tp.diagnostics(u)
    assert got.shape == (tp.fine_space.num_nodes, 8)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    _planes_close(got.T, ref.T, 1e-12)
    _planes_close(got[:, :3].T, u, 1e-15)


def test_diagnostics_shape_and_displacement():
    """The port's counterpart of
    tests/test_solve_mms.py::test_diagnostics_shape_and_displacement: after
    a linElas -test solve the diagnostics are (nnodes, 8) and their first
    three columns are the displacement."""
    cfg = TConfig(problem="linElas", degree=2, nu=0.3, E=1.0, test_mode=True,
                  box_faces=(2, 2, 2), device="cpu")
    prob = TProblem(cfg)
    info = prob.solve()
    d = prob.diagnostics(info.u)
    assert d.shape == (prob.fine_space.num_nodes, 8)
    assert torch.allclose(d[:, :3], info.u.T, rtol=0, atol=1e-12)


def test_diagnostics_in_float64_whatever_the_dtype():
    """A float32 problem's diagnostics are evaluated in float64: from the
    same (float32-representable) u they equal the float64 problem's to
    1e-12 of each column's max |value|."""
    kw = dict(problem="hyperFS", degree=2, nu=0.3, E=1.0, test_mode=True,
              box_faces=(2, 2, 2), multigrid="none", device="cpu")
    p32 = TProblem(TConfig(**kw, dtype=torch.float32))
    p64 = TProblem(TConfig(**kw))
    rng = np.random.default_rng(6)
    u = torch.as_tensor(rng.normal(size=(3, p64.fine_space.num_nodes)) * 1e-3,
                        dtype=torch.float32)
    got, ref = p32.diagnostics(u), p64.diagnostics(u.double())
    assert got.dtype == torch.float64
    _planes_close(got.T, ref.T, 1e-12)


def test_vtu_is_a_copy():
    """post/vtu.py is the JAX package's, line for line below the first line
    of its docstring."""
    j = (REPO / "ceedpetscsolid_tpu/post/vtu.py").read_text().split("\n")
    t = (REPO / "ceedpetscsolid_tpu_torch/post/vtu.py").read_text().split("\n")
    assert t[1:] == j[1:]


@pytest.mark.parametrize("with_diagnostics", [False, True])
def test_write_vtu_byte_identical(tmp_path, with_diagnostics):
    """The same numpy arrays through both packages' write_vtu give the same
    bytes (the scrambled box, degree 3: unstructured numbering)."""
    m = scrambled_box_mesh((2, 2, 2), seed=4)
    jm = jcore.HexMesh(vertices=m.vertices, connectivity=m.connectivity)
    ts, js = tbuild(m, 3), jbuild(jm, 3)
    rng = np.random.default_rng(8)
    u = rng.normal(size=(3, ts.num_nodes))
    diag = rng.normal(size=(ts.num_nodes, 8)) if with_diagnostics else None
    jvtu.write_vtu(str(tmp_path / "j.vtu"), js, u, diag)
    tvtu.write_vtu(str(tmp_path / "t.vtu"), ts, u, diag)
    assert (tmp_path / "t.vtu").read_bytes() == (tmp_path / "j.vtu").read_bytes()


def _read_vtu(path):
    """(structure, arrays): every element's tag and attributes in document
    order, and each DataArray's values by name."""
    root = ET.parse(path).getroot()
    structure = [(e.tag, sorted(e.attrib.items())) for e in root.iter()]
    arrays = {e.get("Name", e.tag): np.array(e.text.split(), float)
              for e in root.iter("DataArray")}
    return structure, arrays


@pytest.mark.parametrize("flag", ["-view_soln", "-view_final_soln"])
def test_cli_view_matches_jax(tmp_path, monkeypatch, capsys, flag):
    """A hyperFS clamp in two increments through both CLIs, each in its own
    working directory: the same files (-view_soln: one a monitor call and
    the final one; -view_final_soln: the final one), the same XML
    structure, and every array to 1e-9 of its max |value| (the files hold
    9 significant digits)."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    dirs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        monkeypatch.chdir(dirs[name])
        assert main(CLAMP_FLAGS + [flag]) == 0
    capsys.readouterr()
    files = sorted(p.name for p in dirs["jax"].iterdir())
    want = ["solution-final.vtu"]
    if flag == "-view_soln":
        want = ["solution-001.vtu", "solution-002.vtu"] + want
    assert files == want
    assert sorted(p.name for p in dirs["torch"].iterdir()) == files
    for f in files:
        s_j, a_j = _read_vtu(dirs["jax"] / f)
        s_t, a_t = _read_vtu(dirs["torch"] / f)
        assert s_t == s_j and sorted(a_t) == sorted(a_j)
        for k, ref in a_j.items():
            assert a_t[k].shape == ref.shape
            assert np.abs(a_t[k] - ref).max() <= 1e-9 * max(
                np.abs(ref).max(), 1e-300), (f, k)
    _, final = _read_vtu(dirs["torch"] / "solution-final.vtu")
    assert "strain_energy_density" in final
