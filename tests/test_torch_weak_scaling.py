"""The port's rank-count sweeps (ceedpetscsolid_tpu_torch/utils/
weak_scaling.py, parallel/tasks.fixed_step) on gloo CPU ranks in float64:
the series' geometry against the JAX package's partition_space, the
fixed-work Newton step against the JAX package's
DistributedProblem(ndev=2, use_slab=False), the summaries on synthetic
records, the invariance series against the port's and the JAX package's
serial solves, and the entry point. Also StageLog's required device.

The JAX oracles compile for most of this file's time, so the port's runs
start before the first test and run meanwhile: its rank processes from a
thread of the pytest process, the entry point as a subprocess."""

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.parallel.partition import \
    partition_space as jax_partition_space
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import native
from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
from ceedpetscsolid_tpu_torch.mesh.exodus import read_exodus
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
from ceedpetscsolid_tpu_torch.mesh.reorder import reorder_mesh
from ceedpetscsolid_tpu_torch.parallel.partition import partition_space
from ceedpetscsolid_tpu_torch.utils import weak_scaling as ws
from ceedpetscsolid_tpu_torch.utils.profile_solve import AMG_SCOPE, \
    step_split
from ceedpetscsolid_tpu_torch.utils.timing import StageLog

# one fixed-work step: hyperFS degree 2, p-MG [1, 2] + AMG, the JAX tool's
# ksp_rtol 0 and ksp_max_it 10; on these stretched elements CG does not
# reach 1e-10 in 10 iterations, so the step does the fixed work
STEP = dict(problem="hyperFS", degree=2, nu=0.3, E=1.0, test_mode=True,
            box_faces=(2, 2, 8), num_increments=1, multigrid="logarithmic",
            ksp_rtol=0.0, ksp_max_it=ws.KSP_ITS)
GEOMETRY = [("jax", 1), ("jax", 2), ("jax", 4), ("card", 1), ("card", 2),
            ("card", 4), ("unstructured", 1), ("unstructured", 4),
            ("invariance", 1), ("invariance", 2), ("invariance", 4)]
PER_RANK = {"jax": 2304, "card": 4096, "unstructured": 704}
# the stages DistributedProblem.refresh_amg and pc_setup record
STAGES = {"refresh_amg", "refresh_amg: residual and stash",
          "refresh_amg: element matrices", "refresh_amg: all_gather",
          "refresh_amg: CSR pattern", "refresh_amg: CSR reduce",
          "refresh_amg: d2h", "refresh_amg: native setup",
          "refresh_amg: extract and upload", "pc_setup",
          "pc_setup: residual and stash", "pc_setup: level diagonals",
          "pc_setup: eigenvalue estimate p1",
          "pc_setup: eigenvalue estimate p2"}
REPO = Path(__file__).resolve().parents[1]
# one weak point and the invariance series at one rank, on the CPU
MAIN = ["--ranks", "1", "--series", "jax,invariance", "--reps", "1",
        "--device", "cpu", "--backend", "gloo", "--quick"]


def _jax_jacobi(cfg):
    """The JAX package's serial Jacobi-CG solve of the invariance mesh, to
    the port's Newton rtol."""
    jcfg = {k: v for k, v in cfg.items() if k != "dtype"}
    jp = JProblem(JConfig(**dict(jcfg, multigrid="none")))
    jp.config.newton.rtol = ws.newton_rtol(torch.float64)
    return np.asarray(jp.solve().u)


def _invariance(cfg):
    """The quick invariance series' serial solve and its two-rank point."""
    serial, u_ser = ws.invariance_serial(cfg, torch.device("cpu"))
    rec = ws.invariance_point(cfg, 2, "gloo", "cpu",
                              Path(cfg["mesh_file"]).parent / "store",
                              serial, u_ser)
    return serial, u_ser, rec


@pytest.fixture(scope="module", autouse=True)
def port(tmp_path_factory):
    """The port's runs, started before the first test: {"step": {n: the
    fixed_step job on n gloo ranks (two timed reps)}, "invariance": the
    quick invariance series' futures (of _invariance, of _jax_jacobi: its
    JAX oracle compiles beside the other test's), "main": (the entry
    point's process, its --out file)}."""
    native.build()                  # once, before any rank needs it
    tmp = tmp_path_factory.mktemp("weak")
    out = tmp / "ws.json"
    main = subprocess.Popen(
        [sys.executable, "-m", "ceedpetscsolid_tpu_torch.utils.weak_scaling",
         *MAIN, "--out", str(out)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    cfg = ws.invariance_config(torch.float64, tmp, quick=True)
    try:
        with ThreadPoolExecutor(1) as pool, ThreadPoolExecutor(1) as jax:
            yield {"step": {n: pool.submit(ws.run_point, STEP,
                                           [("fixed_step", {"reps": 2})], n,
                                           "gloo", "cpu", tmp / "store")
                            for n in (1, 2)},
                   "invariance": (pool.submit(_invariance, cfg),
                                  jax.submit(_jax_jacobi, cfg)),
                   "main": (main, out)}
    finally:
        main.communicate(timeout=600)


def test_stage_log_needs_a_device():
    """StageLog has no default device: a log that forgot it would time
    nothing on the card (its sync returns at once on the CPU)."""
    with pytest.raises(TypeError):
        StageLog()
    log = StageLog(torch.device("cpu"))
    with log.stage("a"):
        pass
    log.add("b", 2.0)
    log.add("b", 1.0)
    assert list(log.seconds()) == ["a", "b"]
    assert log.seconds()["b"] == 3.0 and log.stages["b"][1] == 2


def _space(series, n, directory):
    """The fine FE space a point of the series partitions, as its problem
    builds it (the unstructured meshes read back and reordered)."""
    if series in ("jax", "card"):
        return build_fespace(box_mesh(ws.faces(series, n)),
                             3 if series == "jax" else 4)
    path = ws.exodus_file(ws.faces(series, n), directory)
    return build_fespace(reorder_mesh(read_exodus(str(path))),
                         2 if series == "invariance" else 3)


@pytest.mark.parametrize("series,n", GEOMETRY,
                         ids=[f"{s}-{n}" for s, n in GEOMETRY])
def test_series_geometry(tmp_path, series, n):
    """Full-width geometry: equal elements a rank (the weak series' fixed
    count, the invariance mesh split n ways); the per-rank halo equal to
    the JAX package's partition_space on the same conn; the box series'
    halo one interface plane a rank for n > 1, so constant in n."""
    space = _space(series, n, tmp_path)
    part = partition_space(space.conn, space.num_nodes, n)
    elems = (part.elem_gid >= 0).sum(axis=1)
    per = PER_RANK.get(series, 704 // n)
    assert elems.tolist() == [per] * n
    assert part.halo_stats() == jax_partition_space(
        space.conn, space.num_nodes, n).halo_stats()
    if series in ("jax", "card") and n > 1:
        f, p = ws.faces(series, n), space.degree
        plane = (f[0] * p + 1) * (f[1] * p + 1)
        assert part.halo_stats()["ghosts_per_shard"] == [0] + [plane] * (
            n - 1)


def test_fixed_step_matches_jax_distributed(port):
    """From u0 = 0 with their own refresh_amg and pc_setup, the port's
    fixed step on two ranks against JAX's DistributedProblem(ndev=2,
    use_slab=False).newton_step: rnorm_in and rnorm to 1e-10 relative,
    equal CG iterations, u1 to 1e-10 of max |u1|."""
    from ceedpetscsolid_tpu.parallel.driver import DistributedProblem

    jp = JProblem(JConfig(**STEP))
    dp = DistributedProblem(jp, ndev=2, use_slab=False)
    u0 = dp.to_owned(np.zeros((3, jp.fine_space.num_nodes)))
    amg = dp.refresh_amg(u0, 1.0)
    pc = dp.pc_setup(u0, 1.0)
    u1, rnorm_in, rnorm, iters, _, _ = dp.newton_step(u0, 1.0, amg_data=amg,
                                                      pc=pc)
    got = port["step"][2].result()["fixed_step"]
    assert got["rnorm_in"] == pytest.approx(float(rnorm_in), rel=1e-10)
    assert got["rnorm"] == pytest.approx(float(rnorm), rel=1e-10)
    assert got["iters"] == [int(iters)] * 2
    ref = dp.to_global(u1)
    assert np.abs(got["u1"] - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("world", [1, 2])
def test_fixed_step_does_the_fixed_work(port, world):
    """Every rep ran exactly 10 CG iterations (max_it), every key is
    there, each stage of refresh_amg and pc_setup lies within its phase's
    wall on every rank, the step times are positive, and every rank ran
    with its thread share."""
    out = port["step"][world].result()
    fs = out["fixed_step"]
    assert set(fs) == {"step_s", "iters", "cg_reason", "exchange_s", "clock",
                       "setup_s", "u1", "rnorm_in", "rnorm", "elements",
                       "owned", "dofs", "profile"}
    assert fs["iters"] == [ws.KSP_ITS] * 2
    assert fs["cg_reason"] == ["max_it"] * 2
    assert len(fs["step_s"]) == 2 and min(fs["step_s"]) > 0
    assert fs["clock"] == "host" and fs["profile"] is None
    assert set(fs["exchange_s"]) == {"all_to_all", "all_reduce",
                                     "all_gather"}
    assert fs["elements"] == [32 // world] * world
    assert fs["dofs"] == 3 * (5 * 5 * 17)
    assert len(fs["setup_s"]) == world
    for st in fs["setup_s"]:
        assert set(st) == STAGES
        for phase in ("refresh_amg", "pc_setup"):
            parts = sum(v for k, v in st.items()
                        if k.startswith(phase + ": "))
            assert 0 < parts <= st[phase]
    # one CPU thread a CPU rank, for torch and for the BLAS and OpenMP
    # pools of numpy and the native AMG (launch.THREAD_ENV)
    for st in out["setup"]:
        assert st["threads"] == {"torch": 1, "OMP_NUM_THREADS": "1",
                                 "OPENBLAS_NUM_THREADS": "1",
                                 "MKL_NUM_THREADS": "1"}
    for c in out["fixed_step_counts"]:
        assert c["batch_applies"]["residual"] > 0
        assert c["batch_applies"]["jacobian"] > 0


def _rec(n, ms, dofs, halo):
    return {"series": "jax", "card": "c", "backend": "nccl", "n": n,
            "dofs": dofs, "step_ms_median": ms, "halo_max": halo,
            "fixed_work": True}


def test_weak_summary_on_synthetic_records():
    """E(n) = t(1) / t(n), DoF/s a card = DoF x 10 / t / n, the halo test
    over n > 1 within 5%."""
    recs = [_rec(1, 100.0, 1000, 0), _rec(2, 125.0, 2000, 100),
            _rec(4, 200.0, 4000, 104)]
    s = ws.weak_summary(recs)
    pts = {p["n"]: p for p in s["points"]}
    assert pts[1]["efficiency"] == 1.0
    assert pts[2]["efficiency"] == pytest.approx(0.8)
    assert pts[4]["efficiency"] == pytest.approx(0.5)
    assert pts[1]["dofs_per_s_card"] == pytest.approx(1000 * 10 / 0.1)
    assert pts[4]["dofs_per_s_card"] == pytest.approx(4000 * 10 / 0.2 / 4)
    assert s["halo_constant"] and s["fixed_work"]
    recs[2]["halo_max"] = 106
    assert not ws.weak_summary(recs)["halo_constant"]
    assert ws.weak_summary(recs[1:])["points"][0]["efficiency"] is None
    bad = dict(recs[0], fixed_work=False, ksp_its=[7], cg_reason=["converged"])
    assert ws.weak_failures(bad, on_card=False)
    assert not ws.weak_failures(recs[0], on_card=False)


def _event(name, t0, t1, cuda=True, kernels=(), parent=None):
    """A stand-in for a torch.profiler FunctionEvent (times in us)."""
    dev = torch.autograd.DeviceType
    return SimpleNamespace(
        name=name, device_type=dev.CUDA if cuda else dev.CPU,
        time_range=SimpleNamespace(start=t0, end=t1,
                                   elapsed_us=lambda: t1 - t0),
        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels],
        cpu_parent=parent, is_user_annotation=False)


def test_step_split_on_synthetic_events():
    """The profile's families: the fused kernels by mode and (P, Q) (the
    generic tile's by "(generic)"), NCCL, copies, the rest; by program
    span, the kernels launched under the AMG coarse solve's span and the
    device's idle time under it; the device annotation of that span counts
    nothing; busy time is the union of the device intervals (NCCL beside
    the compute stream); the host's runtime calls by kind, and its
    outermost collectives."""
    scope = _event(AMG_SCOPE, 0, 400, cuda=False)
    a2a = _event("c10d::alltoall_base_", 70, 90, cuda=False)
    mm = _event("aten::mm", 255, 258, cuda=False, parent=scope,
                kernels=[("gemv_kernel", 30)])
    evs = [_event("cps::warp_tile_kernel<2, true, 5, 5, float>", 0, 100),
           _event("cps::generic_reg_kernel<2, false, float, 1>", 100, 150),
           _event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 120, 200),
           _event("Memcpy HtoD (Pinned -> Device)", 200, 210),
           _event("vectorized_elementwise_kernel", 210, 260),
           _event("gemv_kernel", 260, 290), _event(AMG_SCOPE, 250, 300),
           scope, mm, _event("cudaLaunchKernel", 1, 6, cuda=False),
           _event("cudaStreamSynchronize", 10, 50, cuda=False),
           _event("cudaMemcpyAsync", 60, 63, cuda=False), a2a,
           _event("c10d::inner_", 72, 80, cuda=False, parent=a2a)]
    sp = step_split(SimpleNamespace(events=lambda: evs), 0.002, 0.001,
                    spans={AMG_SCOPE})
    fam = {k: (v["launches"], round(v["ms"], 6))
           for k, v in sp["families"].items()}
    assert fam == {"fused J.v (5,5)": (1, 0.1),
                   "fused residual (generic)": (1, 0.05), "NCCL": (1, 0.08),
                   "copies": (1, 0.01), "other": (2, 0.08)}
    # the one gap, 290-400 us, lies inside the span (0-400 us)
    assert {k: (v["launches"], round(v["ms"], 6), round(v["idle_ms"], 6))
            for k, v in sp["spans"].items()} == {
                AMG_SCOPE: (1, 0.03, 0.11)}
    assert sp["launches"] == 5
    assert sp["device_ms"] == pytest.approx(0.32)
    assert sp["busy_ms"] == pytest.approx(0.29)
    assert sp["busy_share"] == pytest.approx(0.29)
    assert sp["wall_ms"] == 2.0 and sp["step_ms"] == 1.0
    host = {k: (v["calls"], round(v["ms"], 6)) for k, v in sp["host"].items()}
    assert host == {"sync": (1, 0.04), "launch": (1, 0.005),
                    "copy": (1, 0.003), "collectives": (1, 0.02)}


def test_invariance_matches_serial_and_jax(port):
    """The quick invariance mesh (a scrambled HEX27 file, degree 2, two
    increments, p-MG + AMG at the fine quadrature) on two ranks against
    the port's serial solve: SNES equal, u to 1e-10 relative; the serial
    solve against the JAX package's serial Jacobi-CG solve of the same
    file to 1e-8 relative (Newton rtol 1e-8: the two preconditioners stop
    at different residuals of the same solution)."""
    runs, jacobi = port["invariance"]
    serial, u_ser, rec = runs.result()
    u_jax = jacobi.result()
    assert serial["converged"] and rec["converged"]
    assert rec["snes"] == serial["snes"]
    assert rec["rel_du"] <= 1e-10
    assert not ws.invariance_failures(rec, ws.invariance_tol(torch.float64),
                                      on_card=False)
    s = ws.invariance_summary([rec])
    assert s["points"][0]["speedup"] is None
    assert np.linalg.norm(u_ser - u_jax) <= 1e-8 * np.linalg.norm(u_jax)


def test_main_prints_parseable_lines(port):
    """python -m ...utils.weak_scaling with MAIN: a JSON line per point
    and per summary, the records written to --out, exit 0 (every check
    held)."""
    main, out = port["main"]
    stdout, stderr = main.communicate(timeout=600)
    assert main.returncode == 0, stderr
    lines = [json.loads(ln) for ln in stdout.splitlines()]
    points = [ln for ln in lines if "n" in ln]
    assert [(p["series"], p["n"]) for p in points] == [("jax", 1),
                                                        ("invariance", 1)]
    assert points[0]["fixed_work"] and points[0]["card"] == "cpu"
    summaries = [ln["summary"]["series"] for ln in lines if "summary" in ln]
    assert summaries == ["jax", "invariance"]
    saved = json.loads(out.read_text())
    assert len(saved["records"]) == 2 and not saved["failures"]


def test_main_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ws.main(["--backend", "gloo", "--quick"])
