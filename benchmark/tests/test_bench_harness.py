"""The harness's own pieces on the CPU: files found by name, the result
line, the roofline count, the import check, the seeded mesh, the trace
reduction, and that a new cell needs only new files."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import common, run as brun, trace
from benchmark.reference import mesh as rmesh, roofline

from .conftest import cell_of_kind, cpu_run, tiny_cell


def test_every_cell_finds_its_files(spec):
    for w in spec["workloads"]:
        cell = common.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert common.kind(cell.traffic["kind"]).run
        assert cell.end_to_end and cell.per_layer
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        for m in cell.per_layer:
            assert callable(common.reader(m["name"]))
            assert m["moves"] in names
    for c in spec["configs"]:
        cfg = common.load_json(common.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        common.load_cell("no-such-cell")


def _outcome():
    return {"setup_s": 12.5, "window_s": 10.1, "attempted": 4, "failed": 0,
            "e2e": {"solve_s": 2.5}, "memory_peak_bytes": 123,
            "records": [{"solve_s": 2.0, "pc_s": 1.5, "snes": 2, "ksp": 20,
                         "wall_s": 2.5, "converged": True,
                         "amg_s": {"setup": 0.5, "upload": 0.25}}],
            "trace": {"busy_s": 0.5, "window_s": 2.0, "kernels": {},
                      "launches": 0, "requests": 1,
                      "device_ops": [["k", 0.5]], "idle_gaps": [["h", 1.5]]},
            "shapes": {"dtype": "float32", "jv": {}},
            "checks": {"residual": [1e-7, 1e-5]}}


def test_result_line_keys():
    cell = common.load_cell(cell_of_kind("solve"))
    line = brun.result_line(cell, _outcome(), False, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"solve_s", "setup_s"}
    assert line["correct"] is True
    traced = brun.result_line(cell, _outcome(), True, {"platform": "gpu"})
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert traced["device"]["busy_s"] == 0.5
    assert traced["metrics"]["pc_share.solve"]["value"] == 75.0
    assert traced["metrics"]["amg_refresh_s.solve"]["value"] == 0.75
    assert traced["metrics"]["device_idle.solve"]["value"] == 75.0
    # a reader that finds nothing leaves its metric out
    assert "jv_roofline.solve" not in traced["metrics"]
    bad = _outcome()
    bad["checks"]["residual"] = [1e-3, 1e-5]
    assert brun.result_line(cell, bad, False, {})["correct"] is False
    json.dumps(traced)


def test_roofline_hand_count():
    # 24^3 p4 float32: 13,824 elements, 97^3 nodes, 5^3 points an element
    nelem, nodes, pts = 13824, 97 ** 3, 125
    hand_bytes = (4 * (3 * nodes + 3 * nodes + 10 * nelem * pts
                       + 9 * nelem * pts) + 4 * nelem * 125)
    assert roofline.jv_bytes(5, 5, nelem, nodes, "float32") == hand_bytes
    assert hand_bytes == 160_144_152
    # per element: forward 3750 + 5625 + 5625 FMAs' worth, adjoint the
    # same, 2 flops an FMA, 616 a point
    hand_flops = nelem * (2 * (15000 + 15000) + 125 * 616)
    assert roofline.jv_flops(5, 5, nelem) == hand_flops
    assert roofline.jv_bound_s(5, 5, nelem, nodes, "float32") == \
        pytest.approx(hand_bytes / 3.35e12)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceedpetscsolid_tpu_torch.fake",
                        types.ModuleType("ceedpetscsolid_tpu_torch.fake"))
    assert "ceedpetscsolid_tpu" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ceedpetscsolid_tpu",
                        types.ModuleType("ceedpetscsolid_tpu"))
    assert "ceedpetscsolid_tpu" in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in common.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (common.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("numpy", "torch", "__future__",
                                          "math"), (path, name)
    code = ("import sys, benchmark.reference.checks, "
            "benchmark.reference.roofline; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith(('ceedpetscsolid', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_seeded_mesh():
    faces = (3, 2, 4)
    a = rmesh.perturbed_vertices(faces, 2 ** 31 + 99, 0.1)
    b = rmesh.perturbed_vertices(faces, 2 ** 31 + 99, 0.1)
    c = rmesh.perturbed_vertices(faces, 2 ** 31 + 100, 0.1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    grid = rmesh.perturbed_vertices(faces, 0, 0.0)
    moved = np.abs(a - grid).max(axis=1) > 0
    n = np.array(faces)
    ijk = np.rint(grid * n).astype(int)
    interior = np.all((ijk > 0) & (ijk < n), axis=1)
    assert np.array_equal(moved, interior)
    assert np.all(np.abs(a - grid) <= 0.1 / n + 1e-15)
    from ceedpetscsolid_tpu_torch.mesh.box import box_mesh

    pm = box_mesh(faces)
    assert np.array_equal(pm.connectivity, rmesh.box_connectivity(faces))
    assert np.allclose(pm.vertices, grid)


def test_trace_reduction():
    ev = [(True, "cps::warp_tile_kernel<0, true, 5, 5, float>", 1.0, 2.0),
          (True, "Memcpy HtoD (Pageable -> Device)", 1.5, 2.5),
          (True, "other_kernel", 4.0, 5.0),
          (True, "outside", 9.0, 11.0),
          (False, "aten::mul", 0.0, 6.0),
          (False, "cudaStreamSynchronize", 2.6, 3.9)]
    t = trace.reduce_events(ev, 0.5, 10.0, 3)
    assert t["busy_s"] == pytest.approx(1.5 + 1.0 + 1.0)
    assert t["window_s"] == pytest.approx(9.5)
    assert t["launches"] == 3
    gaps = dict(t["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1.5)
    assert gaps["aten::mul"] == pytest.approx(0.5)
    assert gaps["host (no operation traced)"] == pytest.approx(4.0)
    assert trace.kernel_family(ev[0][1]) == ("jv", 0, 5, 5)
    assert trace.kernel_family(
        "cps::generic_cluster_kernel<0, false, float>") == (
        "residual", 0, None, None)
    assert trace.kernel_family("other_kernel") is None


def test_new_cell_needs_only_new_files(tmp_path):
    """A cell on an existing configuration and driver with a traffic mix
    of its own: a traffic file, a limits file and one workloads entry; no
    file that is there changes."""
    here = tmp_path / "benchmark"
    shutil.copytree(common.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    spec = common.load_json(common.ROOT / "BENCHMARK.json")
    base = cell_of_kind("cg_solve")
    entry = next(w for w in spec["workloads"] if w["name"] == base)
    name = f"{base}_few"
    spec["workloads"].append({"name": name, "config": entry["config"],
                              "traffic": "cg_jacobi_few", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if base in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = common.load_json(here / "traffic" / f"{entry['traffic']}.json")
    traffic.update(warm_requests=2, check_requests=2)
    (here / "traffic" / "cg_jacobi_few.json").write_text(json.dumps(traffic))
    shutil.copy(here / "limits" / f"{base}.json",
                here / "limits" / f"{name}.json")
    cell = common.load_cell(name, root=tmp_path, here=here)
    cell.config["box_faces"] = [2, 2, 2]
    out = common.kind(cell.traffic["kind"]).run(cpu_run(cell))
    assert all(r["converged"] for r in out["records"])
    line = brun.result_line(cell, out, True, {},
                            read=lambda m: common.reader(m, here=here))
    assert line["correct"] and "launches_per_it.cg" in line["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data


def test_tiny_cell_keeps_the_cells_settings():
    cell = tiny_cell(cell_of_kind("solve"))
    assert cell.config["degree"] == 4 and cell.config["dtype"] == "float32"


def test_reference_leaves_tf32_switches_alone():
    from benchmark.reference import fem

    faces = (2, 2, 2)
    space = fem.BoxSpace(faces, 2, rmesh.perturbed_vertices(faces, 5, 0.1))
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        for setting in (True, False):
            flags.allow_tf32 = setting
            for precision in ("float64", "tf32"):
                fem.HyperFSReference(space, 1.0, 0.3, "cpu",
                                     precision=precision)
                assert flags.allow_tf32 is setting
    finally:
        flags.allow_tf32 = before
