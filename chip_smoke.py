#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ceedpetscsolid_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the CUDA kernels from the checkout's sources (one nvcc per
     compile unit, all started together);
  3. kernel vs its plain torch version on the same inputs: hyperFS degree 4
     on a 24^3 box (13,824 elements, 2,738,019 DoF), degrees 2 and 3 on a
     4^3 box and on the scrambled (unstructured-numbering) 4^3 box, and
     degrees 1 and 2 on the 16^3 box (phase 7's (2,2) and (3,3) levels).
     float64 kernel vs float64 plain: max|diff| <= 1e-12 max|ref|;
     float32 kernel vs float64 plain: |diff| <= 2e-5 |ref| + 1e-6 max|ref|
     (float32 rounding alone reaches ~6e-7 max|ref| in the plain version);
  3b. the fused apply's P < Q instances (2, 5), (3, 5), (5, 6) (a coarse
     p-multigrid level at the fine level's Gauss rule, or -qextra 1) against
     the plain version on the 4^3 box and the scrambled 4^3 box, (2, 5) and
     (3, 5) also on the 8^3 box (phase 8's levels), at the tolerances of
     phase 3, and their CUDA-event times on the 16^3 box;
  3c. the other physics' instances against their plain versions at phase
     3's tolerances, residual (with stash) and J.v: linElas (no stash),
     hyperSS and hyperFSIncomp's mu part at 24^3 degree 4, 4^3 degrees 2
     and 3 and the scrambled 4^3 box; hyperFSIncomp's pressure part at
     (P, 1), P = 2..5, on the 4^3 box and the scrambled 4^3 box; call and
     device times of each at 24^3 degree 4 in float32, kernel and plain;
  4. CUDA-event times (median of 20 calls after warm-up) of kernel and plain
     version, residual and J.v, at the 24^3 degree-4 shapes, in float32: of
     one call, the host's enqueue included, and of the device's work alone
     (utils.timing.cuda_device_ms);
  5. the reference smoke flags in hyperFS form through cli.main, checked
     against the JAX package's result on the same flags;
  6. slice 1's main path: hyperFS degree 4 on a 16^3 box (823,875 DoF),
     -test, -multigrid none (Jacobi CG), one increment, float32, through
     ElasticityProblem; a float64 twin of the same solve checks the answer;
  7. slice 2's main path: the same problem with the p-multigrid
     preconditioner (logarithmic levels [1, 2, 4], native level quadrature,
     Chebyshev(3) smoothers, Chebyshev(30) coarse solve), float32, with its
     float64 twin, held against phase 6's answer and its CG count;
  8. the p-MG solve at 8^3 with fine level quadrature, so that the (2, 5)
     and (3, 5) instances run inside a solve;
  9. the row-gather probes (K3-K6): the entry point
     `python -m ceedpetscsolid_tpu_torch.ops.gather_probe` as a user runs it
     (K3/K4 must launch as thread-block clusters of more than one block),
     then each kernel bitwise against its plain version (NaN rows included)
     on gather_probe.probe_cases: the script's shape, a ragged one, a narrow
     table, one that spans a cluster, one cut into column slabs, and
     out-of-range indices (the JAX ops' wrap, NaN-fill, clamp and zero-row
     semantics); call and device times of each kernel and plain version at
     the probe's shape, and gather_loop vs index_select at the production
     shape;
 10. the reference's own smoke test, its flags exactly (linElas, p-MG
     [1, 2, 3], AMG coarse solve), through cli.main: rc 0, silent, MMS
     rel-L2 within 1% of the JAX package's f64 value (float32 CG stops at
     the CLI's rtol 1e-6: ~1e-6 of |u| through a 2.85e-4 error moves it by
     up to ~0.4%), and its KSP count beside the JAX package's 8;
 11. slice 4's main path: phase 7's problem with the default AMG coarse
     solve, float32, with its float64 twin (same tolerances), held against
     phase 7's answer: AMG levels, J.v launches per CG iteration, the AMG
     refresh split (element matrices, d2h, native setup, upload);
 12. linElas degree 4 on the 16^3 box (-test, p-MG + AMG) with its float64
     twin; the hyperSS and hyperFSIncomp clamp solves of tests/test_amg.py
     and tests/test_incomp.py at 8^3 degree 2, float32 against a float64
     twin at the same tolerances: the same SNES count, KSP within 10%,
     energy to 1e-5;
 13. PCGAMG: linElas -test degree 1 on a 32^3 box (107,811 DoF), CG
     preconditioned by the AMG V-cycle alone, with its float64 twin.
In phases 10-13 CG may exit on p.Ap <= 0 (the sign of an AMG cycle that
stopped being SPD in float32) no more often than in the float64 twin
(phase 12's clamp solves, whose tangents are themselves indefinite at the
first Newton steps), and not at all elsewhere. Kernel launch counters are
set to 0 just before each main path (phases 6-13) and read just after. Then
one JSON line of per-kernel results, the card line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# JAX package, f64 on the CPU, for the phase-5 flags (rc, MMS rel-L2);
# tests/test_torch_problem.py re-checks the port against it on every run.
SMOKE_FLAGS = ["-problem", "hyperFS", "-test", "-degree", "3", "-nu", "0.3",
               "-E", "1", "-dm_plex_box_faces", "3,3,3", "-multigrid", "none",
               "-num_steps", "1"]
SMOKE_REF_RC, SMOKE_REF_L2 = 1, 6.21859e-02
TPU_KERNEL = "ceedpetscsolid_tpu/ops/pallas_apply.py:172"
KERNEL_BOX, SOLVE_BOX = 24, 16       # elements per side: phases 3-4, 6-7
FINE_LEVEL_BOX = 8                   # phase 8
PQ_LESS = ((2, 5), (3, 5), (5, 6))   # phase 3b
NEW_PHYSICS = ("linElas", "hyperSS", "hyperFSIncomp")     # phase 3c
PRESSURE = "hyperFSIncomp-pressure"
# elasticity.c:36 with every default; the JAX package's result on it (f64,
# CPU; tests/test_torch_amg_solve.py re-checks the port on every run)
REFERENCE_SMOKE = ["-test", "-degree", "3", "-nu", "0.3", "-E", "1",
                   "-dm_plex_box_faces", "3,3,3"]
REFERENCE_L2, REFERENCE_KSP, REFERENCE_L2_RTOL = 2.85047e-04, 8, 1e-2
PCGAMG_BOX = 32                      # phase 13
CLAMP_BOX = 8                        # phase 12
CLAMP = {                            # tests/test_amg.py, tests/test_incomp.py
    "hyperSS": dict(problem="hyperSS", degree=2, nu=0.3, E=1e6,
                    forcing="none", bc_clamp=(6, 5),
                    bc_clamp_translate={5: (0.0, 0.0, 0.05)},
                    num_increments=1, multigrid="logarithmic"),
    "hyperFSIncomp": dict(problem="hyperFSIncomp", degree=2, nu=0.49, E=1e6,
                          forcing="none", bc_clamp=(6, 5),
                          bc_clamp_translate={5: (0.05, 0.0, 0.0)},
                          num_increments=1, multigrid="logarithmic",
                          nu_smoother=0.3),
}
CU_SOURCE = "ceedpetscsolid_tpu_torch/csrc/fused_apply.cu"
PROBE_SOURCE = "ceedpetscsolid_tpu_torch/csrc/gather_probe.cu"
PROBE_TPU = {"take": "scripts/try_pallas_gather.py:44",
             "take_along_axis": "scripts/try_pallas_gather.py:56",
             "loop": "scripts/try_pallas_gather.py:70",
             "onehot": "scripts/try_pallas_gather.py:85"}
FAILED = []                          # phase-3 comparisons that failed


def log(msg=""):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def make_case(mesh, degree, dtype, device, seed, qextra=0, q1d=None):
    """Factory, qdata and seeded inputs u, v on `device`. The amplitude
    shrinks with the element size so gradu stays ~1e-2 on every mesh, as
    with the 1e-3 inputs on the 3^3 boxes of tests/test_pallas_apply.py
    (rough inputs at O(1) strain make C nearly singular, where any change
    of rounding order is amplified)."""
    import torch

    from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
    from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory

    f = OperatorFactory(build_fespace(mesh, degree), qextra=qextra,
                        dtype=dtype, device=device, q1d=q1d)
    rng = np.random.default_rng(seed)
    N = f.space.num_nodes
    amp = 3e-3 / round(f.nelem ** (1 / 3))
    u, v = (torch.as_tensor(rng.standard_normal((3, N)) * amp, dtype=dtype,
                            device=device) for _ in range(2))
    return f, f.compute_qdata(), u, v


def compare(name, got, ref, f64):
    """Raise unless `got` (kernel) agrees with `ref` (float64 plain)."""
    import torch

    err = (got.to(torch.float64) - ref).abs()
    mx = float(ref.abs().max())
    rel = float(err.max()) / mx
    if f64:
        ok = rel <= 1e-12
    else:
        ok = bool((err <= 2e-5 * ref.abs() + 1e-6 * mx).all())
    log(f"    {name:34s} max|ref| {mx:.3e}  max|diff| {float(err.max()):.3e}"
        f"  rel-to-max {rel:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILED.append(name)
    return float(err.max())


def check_kernel(label, mesh, degree, device, phys, qextra=0,
                 physics="hyperFS", q1d=None):
    """Kernel vs plain on one mesh/degree (P = degree + 1, Q = P + qextra,
    or q1d), f64 and f32; returns the f32 max abs errors (residual ve,
    J.v). A physics without a stash (linElas) must return none."""
    import torch

    from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
    from ceedpetscsolid_tpu_torch.ops.basis import Basis3D

    f, q, u, v = make_case(mesh, degree, torch.float64, device, seed=degree,
                           qextra=qextra, q1d=q1d)
    conn, b64 = f.restr.conn, f.basis
    ve0, st0 = fa.residual_plain(u, conn, q, b64, phys, physics)
    jv0 = fa.jacobian_plain(v, conn, q, st0, b64, phys, physics)
    ve, st = fa.residual(u, conn, q, b64, phys, physics)
    jv = fa.jacobian(v, conn, q, st0, b64, phys, physics)
    torch.cuda.synchronize()
    if (st is None) != (st0 is None):
        FAILED.append(f"{label}: kernel stash {st is None}, "
                      f"plain {st0 is None}")
    pairs = [("residual ve", ve, ve0), ("stash", st, st0), ("J.v ve", jv, jv0)]
    pairs = [(nm, a, b) for nm, a, b in pairs if b is not None]
    for nm, a, b in pairs:
        compare(f"{label} f64 {nm}", a, b, True)
    f32 = torch.float32
    b32 = Basis3D.create(b64.P, b64.Q, "gauss", f32, device)
    q32 = q.to(f32)
    ve, st = fa.residual(u.to(f32), conn, q32, b32, phys, physics)
    jv = fa.jacobian(v.to(f32), conn, q32, None if st0 is None else
                     st0.to(f32), b32, phys, physics)
    torch.cuda.synchronize()
    e_r = compare(f"{label} f32 residual ve", ve, ve0, False)
    if st0 is not None:
        compare(f"{label} f32 stash", st, st0, False)
    e_j = compare(f"{label} f32 J.v ve", jv, jv0, False)
    return e_r, e_j


def run_cli(flags):
    """cli.main(flags) with its standard output captured: (rc, output, the
    problem it solved, its SolveInfo)."""
    from ceedpetscsolid_tpu_torch import cli
    from ceedpetscsolid_tpu_torch.problem import ElasticityProblem

    seen = []
    orig = ElasticityProblem.solve

    def spy(self, *args, **kw):
        info = orig(self, *args, **kw)
        seen.append((self, info))
        return info

    ElasticityProblem.solve = spy
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(flags))
    ElasticityProblem.solve = orig
    return (rc, buf.getvalue(), *seen[-1])


def gather_phase(dev, card):
    """Phase 9. The probe entry point as a user runs it, launch counts set
    to 0 just before and read just after; then every kernel against its
    plain version on gather_probe.probe_cases; then call and device times
    at the probe's shape and the production-shape gather. Returns the
    entry point's launches, each kernel's max abs difference over the cases
    and its times."""
    from ceedpetscsolid_tpu_torch.ops import gather_probe as gp

    gp.COUNTS.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gp.main([])
    launches = dict(gp.COUNTS.launches)
    clusters = dict(gp.COUNTS.cluster_dims)
    log("[9] python -m ceedpetscsolid_tpu_torch.ops.gather_probe -> rc "
        f"{rc}, launches {launches}")
    for line in buf.getvalue().splitlines():
        log("    | " + line)
    if rc != 0 or min(launches.values()) < 1:
        raise AssertionError("gather probe entry point failed")
    log(f"    K3/K4 launch attribute cudaLaunchAttributeClusterDimension: "
        f"{clusters}")
    if any(clusters.get(k, (1,))[0] < 2 for k in gp.STAGED):
        raise AssertionError(f"K3/K4 did not launch as clusters: {clusters}")
    errs, bad = dict.fromkeys(gp.KINDS, 0.0), []
    for label, tab, idx in gp.probe_cases(dev):
        (W, C), R = tab.shape, idx.shape[0]
        p = gp.plan(W, C, R)
        cmp = gp.compare_probes(tab, idx)
        log(f"    {label:32s} cluster {p.cs} x {C // p.slab} slab(s) x "
            f"{p.groups} group(s): " + ", ".join(
                f"{n} {'bitwise' if eq else 'DIFFERS'} {e:.1e}"
                for n, (eq, e) in cmp.items()))
        for n, (eq, e) in cmp.items():
            errs[n] = max(errs[n], e)
            if not eq:
                bad.append((label, n))
    if bad:
        raise AssertionError(f"a probe kernel differs from its plain version: "
                             f"{bad}")
    tab, idx = gp.probe_inputs(dev)
    times, bare = gp.time_probes(tab, idx), gp.time_index(tab, idx)
    W, R, C = gp.PROBE_SHAPE
    log(f"    times at ({W}, {C}) / ({R},) ({card}): one call (host enqueue "
        "included) / device alone")
    log(f"    bare tab[idx]            {bare['ms']:.4f} / "
        f"{bare['device_ms']:.4f} ms")
    for name, t in times.items():
        log(f"    gather_{name:16s} {t['ms']:.4f} / {t['device_ms']:.4f} ms  "
            f"(plain {t['plain_ms']:.4f} / {t['plain_device_ms']:.4f} ms)")
    prod = gp.time_production(dev)
    Wp, Rp, Cp = gp.PRODUCTION_SHAPE
    log(f"    production ({Rp} rows of {Cp} from ({Wp}, {Cp}), "
        f"{prod['gb']:.4f} GB): gather_loop {prod['ms']:.4f} ms "
        f"({prod['gbps']:.1f} GB/s), index_select {prod['plain_ms']:.4f} ms "
        f"({prod['plain_gbps']:.1f} GB/s) ({card})")
    return launches, errs, times


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on a GPU", file=sys.stderr)
        return 2
    try:
        import ceedpetscsolid_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: package ceedpetscsolid_tpu_torch not found beside "
              f"this script ({exc})", file=sys.stderr)
        return 3
    from ceedpetscsolid_tpu_torch import cli, native
    from ceedpetscsolid_tpu_torch.csrc.build import build
    from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
    from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh
    from ceedpetscsolid_tpu_torch.models import Physics
    from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
    from ceedpetscsolid_tpu_torch.problem import (
        Config, ElasticityProblem, select_device)
    from ceedpetscsolid_tpu_torch.utils.profile_solve import make_problem
    from ceedpetscsolid_tpu_torch.utils.timing import (
        cuda_device_ms as device_ms)
    from ceedpetscsolid_tpu_torch.utils.timing import cuda_time_ms as time_ms

    dev = select_device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    # ---- 1. card --------------------------------------------------------
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    # the native AMG library (g++) builds beside the CUDA kernels (parallel
    # nvcc), so no solve below times its first-use build
    def build_native():
        t = time.perf_counter()
        return native.build(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        amg_build = pool.submit(build_native)
        lib, ptx = build()
    amg_lib, amg_s = amg_build.result()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptx)]
    spills = [ln.strip() for ln in ptx.splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    log(f"[2] kernel build {time.perf_counter() - t0:.1f} s -> {lib.name}: "
        f"{len(regs)} kernels, registers {min(regs, default=0)}-"
        f"{max(regs, default=0)}, {len(spills)} with spills")
    for line in spills:
        log("    " + line)
    log(f"    native AMG library {amg_lib.name}: {amg_s:.1f} s (g++, "
        "beside the kernel build)")

    # ---- 3. kernel vs plain ---------------------------------------------
    phys = Physics(nu=0.3, E=1.0)
    log("[3] kernel vs plain version")
    n = KERNEL_BOX
    errs = check_kernel(f"{n}^3 p4 box", box_mesh((n, n, n)), 4, dev, phys)
    for deg in (2, 3):
        errs += check_kernel(f"4^3 p{deg} box", box_mesh((4, 4, 4)), deg, dev,
                             phys)
        errs += check_kernel(f"4^3 p{deg} scrambled",
                             scrambled_box_mesh((4, 4, 4), 4), deg, dev, phys)
    m = SOLVE_BOX
    for deg in (1, 2):      # phase 7's p = 1 and p = 2 levels, (2,2), (3,3)
        errs += check_kernel(f"{m}^3 p{deg} box", box_mesh((m, m, m)), deg,
                             dev, phys)
    log("[3b] P < Q instances vs plain version")
    k = FINE_LEVEL_BOX
    for P, Q in PQ_LESS:
        for label, mesh in (("box", box_mesh((4, 4, 4))),
                            ("scrambled", scrambled_box_mesh((4, 4, 4), 4))):
            errs += check_kernel(f"4^3 (P,Q)=({P},{Q}) {label}", mesh,
                                 P - 1, dev, phys, qextra=Q - P)
        if Q == 5:          # phase 8's fine-quadrature levels
            errs += check_kernel(f"{k}^3 (P,Q)=({P},{Q}) box",
                                 box_mesh((k, k, k)), P - 1, dev, phys,
                                 qextra=Q - P)
    if FAILED:
        raise AssertionError(f"kernel disagrees with plain version: {FAILED}")
    log(f"    times at {m}^3, float32 ({card}):")
    for P, Q in PQ_LESS:
        f, q, u, v = make_case(box_mesh((m, m, m)), P - 1, torch.float32, dev,
                               P, qextra=Q - P)
        conn, b = f.restr.conn, f.basis
        _, st = fa.residual_plain(u, conn, q, b, phys)
        t = [time_ms(lambda: fa.residual(u, conn, q, b, phys)),
             time_ms(lambda: fa.residual_plain(u, conn, q, b, phys)),
             time_ms(lambda: fa.jacobian(v, conn, q, st, b, phys)),
             time_ms(lambda: fa.jacobian_plain(v, conn, q, st, b, phys))]
        log(f"    (P,Q)=({P},{Q}) residual {t[0]:.4f} ms (plain {t[1]:.4f} ms)"
            f", J.v {t[2]:.4f} ms (plain {t[3]:.4f} ms)")
    del f, q, u, v, st

    # ---- 3c. the other physics vs plain version -----------------------------
    log("[3c] linElas, hyperSS, hyperFSIncomp (mu part, pressure part) vs "
        "plain version")
    perr = {}           # physics -> f32 max abs errors (residual, J.v, ...)
    for ph in NEW_PHYSICS:
        perr[ph] = check_kernel(f"{n}^3 p4 box {ph}", box_mesh((n, n, n)), 4,
                                dev, phys, physics=ph)
        for deg in (2, 3):
            perr[ph] += check_kernel(f"4^3 p{deg} box {ph}",
                                     box_mesh((4, 4, 4)), deg, dev, phys,
                                     physics=ph)
            perr[ph] += check_kernel(f"4^3 p{deg} scrambled {ph}",
                                     scrambled_box_mesh((4, 4, 4), 4), deg,
                                     dev, phys, physics=ph)
    perr[PRESSURE] = ()
    for P in range(2, 6):
        for label, mesh in (("box", box_mesh((4, 4, 4))),
                            ("scrambled", scrambled_box_mesh((4, 4, 4), 4))):
            perr[PRESSURE] += check_kernel(
                f"4^3 (P,Q)=({P},1) {label} pressure", mesh, P - 1, dev,
                phys, physics=PRESSURE, q1d=1)
    if FAILED:
        raise AssertionError(f"kernel disagrees with plain version: {FAILED}")
    ptimes = {}
    log(f"    times at {n}^3 p4, float32 ({card}): call (host enqueue "
        "included) / device alone")
    for ph in (*NEW_PHYSICS, PRESSURE):
        f, q, u, v = make_case(box_mesh((n, n, n)), 4, torch.float32, dev, 4,
                               q1d=1 if ph == PRESSURE else None)
        conn, b = f.restr.conn, f.basis
        _, st = fa.residual_plain(u, conn, q, b, phys, ph)
        calls = {
            "residual": lambda: fa.residual(u, conn, q, b, phys, ph),
            "residual_plain": lambda: fa.residual_plain(u, conn, q, b, phys,
                                                        ph),
            "jacobian": lambda: fa.jacobian(v, conn, q, st, b, phys, ph),
            "jacobian_plain": lambda: fa.jacobian_plain(v, conn, q, st, b,
                                                        phys, ph),
        }
        t = {k: time_ms(fn) for k, fn in calls.items()}
        d = {k: device_ms(fn, reps=10, inner=1) for k, fn in calls.items()}
        ptimes[ph] = (t, d)
        for mode in ("residual", "jacobian"):
            log(f"    {ph:24s} ({b.P},{b.Q}) {mode:8s} {t[mode]:.4f} / "
                f"{d[mode]:.4f} ms  (plain {t[mode + '_plain']:.4f} / "
                f"{d[mode + '_plain']:.4f} ms)")
        del f, q, u, v, st, calls
    torch.cuda.empty_cache()

    # ---- 4. times at the 24^3 degree-4 shapes, float32 ----------------------
    f, q, u, v = make_case(box_mesh((n, n, n)), 4, torch.float32, dev, 4)
    conn, b = f.restr.conn, f.basis
    _, st = fa.residual_plain(u, conn, q, b, phys)
    ndof = 3 * f.space.num_nodes
    res_op = f.make_residual_structured("hyperFS", phys)
    jac_op = f.make_jacobian_structured("hyperFS", phys)
    calls = {
        "residual": lambda: fa.residual(u, conn, q, b, phys),
        "residual_plain": lambda: fa.residual_plain(u, conn, q, b, phys),
        "jacobian": lambda: fa.jacobian(v, conn, q, st, b, phys),
        "jacobian_plain": lambda: fa.jacobian_plain(v, conn, q, st, b, phys),
        "residual_operator": lambda: res_op(u, q),
        "jacobian_operator": lambda: jac_op(v, q, st),
    }
    times = {k: time_ms(fn) for k, fn in calls.items()}
    # one call a sample: the plain versions launch so many kernels that ten
    # fill the launch queue, and the host then waits on the held stream
    dtimes = {k: device_ms(calls[k], reps=10, inner=1) for k in
              ("residual", "residual_plain", "jacobian", "jacobian_plain")}
    log(f"[4] times at {n}^3 p4, float32, {ndof} DoF ({card})")
    for k, t in times.items():
        dev_t = f"  device {dtimes[k]:9.4f} ms" if k in dtimes else ""
        log(f"    {k:20s} {t:9.4f} ms  {1e-3 * ndof / t:10.1f} MDoF/s{dev_t}")
    del f, q, u, v, st, res_op, jac_op, calls
    torch.cuda.empty_cache()

    # ---- 5. reference smoke flags in hyperFS form ---------------------------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(SMOKE_FLAGS))
    m = re.search(r"L2 Error: (\S+)", buf.getvalue())
    l2 = float(m.group(1)) if m else 0.0
    log(f"[5] cli.main({' '.join(SMOKE_FLAGS)}) -> rc {rc}, MMS rel-L2 {l2} "
        f"(JAX package, f64 CPU: rc {SMOKE_REF_RC}, {SMOKE_REF_L2})")
    if rc != SMOKE_REF_RC or abs(l2 - SMOKE_REF_L2) > 1e-3 * SMOKE_REF_L2:
        raise AssertionError("CLI smoke disagrees with the JAX package")

    # ---- 6-8. solves through ElasticityProblem -----------------------------
    def solve(dtype, box, multigrid="none", level_quadrature="native",
              by_physics=False, **kw):
        """One -test increment (hyperFS degree 4 unless kw says otherwise);
        launch counts are set to 0 just before the solve and read just
        after, by (mode, P, Q) or by (physics, mode, P, Q)."""
        prob = make_problem(box, multigrid, dev, dtype, level_quadrature,
                            **kw)
        fa.COUNTS.reset()
        info = prob.solve()
        counts = dict(fa.COUNTS.by_physics if by_physics else fa.COUNTS.by_pq)
        return prob, info, counts, prob.mms_error(info.u), \
            prob.strain_energy(info.u)

    def report(tag, prob, info, counts, err, energy):
        log(f"{tag} {info.dofs} DoF, levels {prob.level_degrees}, setup "
            f"{prob.setup_time:.2f} s")
        log(f"    converged {info.converged} ({info.reason}), SNES "
            f"{info.snes_iters}, KSP {info.ksp_iters}, rnorm {info.rnorm:.3e}")
        log(f"    solve {info.solve_time:.3f} s (preconditioner setup "
            f"{info.pc_time:.3f} s), {info.mdofs_per_sec:.2f} MDoF/s "
            f"(1e-6 dofs KSP / time) ({card})")
        log(f"    MMS rel-L2 {err:.6e}, strain energy {energy:.10e}")
        log("    kernel launches: " + ", ".join(
            f"{' '.join(map(str, key[:-2]))} (P,Q)=({key[-2]},{key[-1]}) {k}"
            for key, k in sorted(counts.items())))
        if not info.converged or not math.isfinite(err):
            raise AssertionError(f"{tag} solve did not converge")

    def check_twin(tag, box, info, err, energy, du_slack=False, **kw):
        """The float64 twin of a float32 solve: same answer to 1e-3. With
        du_slack the MMS errors may also differ by |u32 - u64| / |u*|
        (the triangle inequality's bound), for a discretization error
        (1.8e-6 in linElas p4 on 16^3) within reach of the float32 solve's
        own error."""
        prob64, info64, _, err64, en64 = solve(torch.float64, box, **kw)
        du = float(torch.linalg.norm(info.u.double() - info64.u)
                   / torch.linalg.norm(info64.u))
        log(f"    float64 twin: SNES {info64.snes_iters}, KSP "
            f"{info64.ksp_iters} (float32 {info.ksp_iters}), MMS rel-L2 "
            f"{err64:.6e}, energy {en64:.10e}, |u32-u64|/|u64| {du:.3e}")
        slack = du * (1 + err64) if du_slack else 0.0
        if not (info64.converged and du <= 1e-3
                and abs(err - err64) <= 1e-3 * err64 + slack
                and abs(energy - en64) <= 1e-3 * abs(en64)):
            raise AssertionError(f"{tag} float32 solve disagrees with its "
                                 "float64 twin")

    def fine_jv_ms(prob, info):
        """CUDA-event time of one BC-masked fine J.v operator at the
        solution."""
        _, stash = prob._nonlinear_residual(info.u, prob.bc_values(1.0),
                                            prob.F)
        return time_ms(lambda: prob._jacobian_action(info.u, stash))

    # ---- 6. slice 1's main path: Jacobi CG ----------------------------------
    prob, info, c6, err6, en6 = solve(torch.float32, SOLVE_BOX)
    report(f"[6] hyperFS p4 {SOLVE_BOX}^3 float32, Jacobi CG:", prob, info, c6,
           err6, en6)
    launches6 = {m: sum(k for (mm, _, _), k in c6.items() if mm == m)
                 for m in ("residual", "jacobian")}
    if min(launches6.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches6}")
    t_mv = fine_jv_ms(prob, info)
    ksp6 = info.ksp_iters
    log(f"    J.v operator {t_mv:.4f} ms vs "
        f"{info.solve_time / max(ksp6, 1) * 1e3:.4f} ms wall per KSP "
        "iteration (the rest: vector ops, Newton/line search, host syncs)")
    check_twin("[6]", SOLVE_BOX, info, err6, en6)
    del prob, info
    torch.cuda.empty_cache()

    # ---- 7. slice 2's main path: p-multigrid CG ----------------------------
    pmg = dict(multigrid="logarithmic", level_quadrature="native")
    prob, info, c7, err7, en7 = solve(torch.float32, SOLVE_BOX, **pmg)
    report(f"[7] hyperFS p4 {SOLVE_BOX}^3 float32, p-MG CG (native levels, "
           "Chebyshev coarse):", prob, info, c7, err7, en7)
    need = [("residual", 5, 5), ("jacobian", 5, 5), ("jacobian", 3, 3),
            ("jacobian", 2, 2)]
    if min(c7.get(k, 0) for k in need) < 1:
        raise AssertionError(f"p-MG path skipped a kernel instance: {c7}")
    launches7 = {m: sum(k for (mm, _, _), k in c7.items() if mm == m)
                 for m in ("residual", "jacobian")}
    t_mv = fine_jv_ms(prob, info)
    per_it = (info.solve_time - info.pc_time) / max(info.ksp_iters, 1) * 1e3
    log(f"    {launches7['jacobian'] / max(info.ksp_iters, 1):.1f} J.v kernel "
        "launches per CG iteration (eigenvalue-estimate applies included); "
        f"wall per CG iteration {per_it:.4f} ms (solve minus preconditioner "
        f"setup, over KSP) vs one fine J.v operator {t_mv:.4f} ms")
    log(f"    vs phase 6 (Jacobi): KSP {info.ksp_iters} vs {ksp6}; MMS rel-L2 "
        f"{err7:.6e} vs {err6:.6e}; energy {en7:.10e} vs {en6:.10e}")
    if not info.ksp_iters < ksp6:
        raise AssertionError("p-MG took no fewer CG iterations than Jacobi")
    c7_ksp = info.ksp_iters
    if not (abs(err7 - err6) <= 1e-3 * err6 and abs(en7 - en6) <= 1e-3 * en6):
        raise AssertionError("p-MG answer disagrees with the Jacobi answer")
    check_twin("[7]", SOLVE_BOX, info, err7, en7, **pmg)
    del prob, info
    torch.cuda.empty_cache()

    # ---- 8. p-MG with fine level quadrature -------------------------------
    prob, info, c8, err8, en8 = solve(torch.float32, FINE_LEVEL_BOX,
                                      multigrid="logarithmic",
                                      level_quadrature="fine")
    report(f"[8] hyperFS p4 {FINE_LEVEL_BOX}^3 float32, p-MG CG (fine "
           "levels):", prob, info, c8, err8, en8)
    if min(c8.get(("jacobian", P, 5), 0) for P in (2, 3, 5)) < 1:
        raise AssertionError(f"fine-level path skipped an instance: {c8}")
    del prob, info

    # ---- 9. row-gather probes ---------------------------------------------
    launches9, gerr, gtimes = gather_phase(dev, card)
    main_counts = [c6, c7, c8]          # by (mode, P, Q), hyperFS only

    def need(tag, counts, keys):
        missing = [k for k in keys if counts.get(k, 0) < 1]
        if missing:
            raise AssertionError(f"{tag} skipped kernel instances {missing}: "
                                 f"{counts}")

    def amg_report(prob, info, twin=None):
        """AMG levels, CG exits and the refresh split. Raises when CG exited
        on p.Ap <= 0 more often than in the float64 twin (`twin`, whose
        tangent may itself be indefinite), or at all without one."""
        cg = prob.cg_exits
        log(f"    AMG levels (n, representation): "
            f"{prob._amg.level_summary()}; CG exits {cg}")
        t = prob.amg_times
        log(f"    AMG refreshes {prob.pc_setups}: element matrices "
            f"{t['elem_mats']:.4f} s, d2h {t['d2h']:.4f} s, native setup "
            f"{t['setup']:.4f} s, upload {t['upload']:.4f} s (inside "
            f"preconditioner setup {info.pc_time:.4f} s) ({card})")
        allowed = 0 if twin is None else twin.cg_exits.get("indefinite", 0)
        if cg.get("indefinite", 0) > allowed:
            raise AssertionError("CG with the AMG cycle exited on p.Ap <= 0 "
                                 f"{cg['indefinite']} times (float64 twin: "
                                 f"{allowed})")

    # ---- 10. the reference's smoke test, its flags exactly ------------------
    fa.COUNTS.reset()
    rc, out, prob, info = run_cli(REFERENCE_SMOKE)
    c10 = dict(fa.COUNTS.by_physics)
    l2 = prob.mms_error(info.u)
    log(f"[10] cli.main({' '.join(REFERENCE_SMOKE)}) -> rc {rc}, output "
        f"{out!r}; {prob.config.problem}, levels {prob.level_degrees}, "
        f"{str(prob.dtype)}, SNES {info.snes_iters}, KSP {info.ksp_iters} "
        f"(JAX package, f64 CPU: {REFERENCE_KSP}), MMS rel-L2 {l2:.6e} (JAX "
        f"{REFERENCE_L2}; |diff| {abs(l2 - REFERENCE_L2) / REFERENCE_L2:.2e} "
        f"relative, tolerance {REFERENCE_L2_RTOL})")
    amg_report(prob, info)
    log("    kernel launches: " + ", ".join(
        f"{ph} {m} ({P},{Q}) {k}" for (ph, m, P, Q), k in sorted(c10.items())))
    if (rc != 0 or out
            or abs(l2 - REFERENCE_L2) > REFERENCE_L2_RTOL * REFERENCE_L2):
        raise AssertionError("the reference smoke test failed on the port")
    need("[10]", c10, [("linElas", "residual", 4, 4),
                       ("linElas", "jacobian", 4, 4),
                       ("linElas", "jacobian", 3, 3),
                       ("linElas", "jacobian", 2, 2)])
    del prob, info

    # ---- 11. slice 4's main path: p-MG with the AMG coarse solve ------------
    amg = dict(multigrid="logarithmic", level_quadrature="native",
               coarse_solve="amg", by_physics=True)
    prob, info, c11, err11, en11 = solve(torch.float32, SOLVE_BOX, **amg)
    report(f"[11] hyperFS p4 {SOLVE_BOX}^3 float32, p-MG CG (native levels, "
           "AMG coarse):", prob, info, c11, err11, en11)
    amg_report(prob, info)
    need("[11]", c11, [("hyperFS", "residual", 5, 5),
                       ("hyperFS", "jacobian", 5, 5),
                       ("hyperFS", "jacobian", 3, 3),
                       ("hyperFS", "jacobian", 2, 2)])
    jv11 = sum(k for (_, m, _, _), k in c11.items() if m == "jacobian")
    per_it = (info.solve_time - info.pc_time) / max(info.ksp_iters, 1) * 1e3
    log(f"    {jv11 / max(info.ksp_iters, 1):.1f} J.v kernel launches per CG "
        f"iteration (eigenvalue-estimate applies included); wall per CG "
        f"iteration {per_it:.4f} ms")
    log(f"    vs phase 7 (Chebyshev coarse): KSP {info.ksp_iters} vs "
        f"{c7_ksp}; MMS rel-L2 {err11:.6e} vs {err7:.6e}; energy "
        f"{en11:.10e} vs {en7:.10e}")
    if not (abs(err11 - err7) <= 1e-3 * err7
            and abs(en11 - en7) <= 1e-3 * en7):
        raise AssertionError("p-MG + AMG answer disagrees with phase 7's")
    ksp11 = info.ksp_iters
    check_twin("[11]", SOLVE_BOX, info, err11, en11, f32_tolerances=True,
               du_slack=True, **amg)
    main_counts.append(c11)
    del prob, info
    torch.cuda.empty_cache()

    # ---- 12. linElas degree 4; the hyperSS and hyperFSIncomp clamp solves ---
    lin = dict(amg, problem="linElas")
    prob, info, c12, err12, en12 = solve(torch.float32, SOLVE_BOX, **lin)
    report(f"[12] linElas p4 {SOLVE_BOX}^3 float32, p-MG CG + AMG:", prob,
           info, c12, err12, en12)
    amg_report(prob, info)
    need("[12]", c12, [("linElas", "residual", 5, 5),
                       ("linElas", "jacobian", 5, 5),
                       ("linElas", "jacobian", 3, 3),
                       ("linElas", "jacobian", 2, 2)])
    check_twin("[12]", SOLVE_BOX, info, err12, en12, f32_tolerances=True,
               du_slack=True, **lin)
    main_counts.append(c12)
    del prob, info
    torch.cuda.empty_cache()
    for name, kw in CLAMP.items():
        runs = {}
        for dtype in (torch.float32, torch.float64):
            cfg = Config(**kw, box_faces=(CLAMP_BOX,) * 3, device=dev,
                         dtype=dtype, ksp_rtol=1e-6)
            cfg.newton.rtol = 1e-6      # the CLI's float32 policy, both
            p12 = ElasticityProblem(cfg)
            fa.COUNTS.reset()
            i12 = p12.solve()
            runs[dtype] = (p12, i12, dict(fa.COUNTS.by_physics),
                           p12.strain_energy(i12.u))
        (p32, i32, c32, w32), (p64, i64, _, w64) = runs.values()
        log(f"[12] {name} clamp, degree 2 on {CLAMP_BOX}^3 "
            f"({i32.dofs} DoF), p-MG + AMG, float32 / float64: converged "
            f"{i32.converged} / {i64.converged}, SNES {i32.snes_iters} / "
            f"{i64.snes_iters}, KSP {i32.ksp_iters} / {i64.ksp_iters}, "
            f"energy {w32:.10e} / {w64:.10e}, solve {i32.solve_time:.3f} / "
            f"{i64.solve_time:.3f} s ({card})")
        log(f"    float64 twin CG exits {p64.cg_exits}")
        amg_report(p32, i32, twin=p64)
        log("    kernel launches: " + ", ".join(
            f"{ph} {m} ({P},{Q}) {k}" for (ph, m, P, Q), k in
            sorted(c32.items())))
        if not (i32.converged and i64.converged
                and i32.snes_iters == i64.snes_iters
                and abs(i32.ksp_iters - i64.ksp_iters) <= 0.1 * i64.ksp_iters
                and abs(w32 - w64) <= 1e-5 * abs(w64)):
            raise AssertionError(f"[12] {name} float32 clamp solve disagrees "
                                 "with its float64 twin")
        keys = [(name, "residual", 3, 3), (name, "jacobian", 3, 3),
                (name, "jacobian", 2, 2)]
        if name == "hyperFSIncomp":
            keys += [(PRESSURE, "residual", 3, 1),
                     (PRESSURE, "jacobian", 3, 1),
                     (PRESSURE, "jacobian", 2, 1)]
        need(f"[12] {name}", c32, keys)
        main_counts.append(c32)
        del p32, p64, i32, i64, runs
    torch.cuda.empty_cache()

    # ---- 13. PCGAMG: degree 1, CG preconditioned by the AMG alone -----------
    pcgamg = dict(multigrid="logarithmic", coarse_solve="amg",
                  problem="linElas", degree=1, by_physics=True)
    prob, info, c13, err13, en13 = solve(torch.float32, PCGAMG_BOX, **pcgamg)
    report(f"[13] linElas p1 {PCGAMG_BOX}^3 float32, PCGAMG (CG + AMG "
           "V-cycle):", prob, info, c13, err13, en13)
    amg_report(prob, info)
    if prob._use_mg or not prob._use_amg:
        raise AssertionError("[13] did not run PCGAMG")
    need("[13]", c13, [("linElas", "residual", 2, 2),
                       ("linElas", "jacobian", 2, 2)])
    check_twin("[13]", PCGAMG_BOX, info, err13, en13, f32_tolerances=True,
               du_slack=True, **pcgamg)
    main_counts.append(c13)
    main_counts.append(c10)
    del prob, info
    torch.cuda.empty_cache()

    def instances(physics, mode):
        """'P,Q' -> launches of one physics and mode over the main paths."""
        out = {}
        for c in main_counts:
            for key, k in c.items():
                ph, m, P, Q = key if len(key) == 4 else ("hyperFS", *key)
                if (ph, m) == (physics, mode):
                    out[f"{P},{Q}"] = out.get(f"{P},{Q}", 0) + k
        return out

    kernels = [
        {"name": f"fused_apply_{mode}", "route": "cuda", "source": CU_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches7[mode],
         "max_abs_err": e, "ms": times[mode], "plain_ms": times[mode + "_plain"],
         "device_ms": dtimes[mode], "plain_device_ms": dtimes[mode + "_plain"],
         "physics": "hyperFS", "instances": instances("hyperFS", mode)}
        for mode, e in (("residual", max(errs[0::2])),
                        ("jacobian", max(errs[1::2])))
    ] + [
        {"name": f"fused_apply_{mode}[{ph}]", "route": "cuda",
         "source": CU_SOURCE, "replaces": TPU_KERNEL,
         "launches": sum(instances(ph, mode).values()),
         "max_abs_err": max(perr[ph][i::2]), "ms": ptimes[ph][0][mode],
         "plain_ms": ptimes[ph][0][mode + "_plain"],
         "device_ms": ptimes[ph][1][mode],
         "plain_device_ms": ptimes[ph][1][mode + "_plain"],
         "physics": ph, "instances": instances(ph, mode)}
        for ph in (*NEW_PHYSICS, PRESSURE)
        for i, mode in enumerate(("residual", "jacobian"))
    ] + [
        {"name": f"gather_{name}", "route": "cuda", "source": PROBE_SOURCE,
         "replaces": PROBE_TPU[name], "launches": launches9[name],
         "max_abs_err": gerr[name], **gtimes[name]}
        for name in PROBE_TPU
    ]
    if min(k["launches"] for k in kernels) < 1:
        raise AssertionError("a kernel was launched no time on the main "
                             f"paths: {[k['name'] for k in kernels]}")
    log(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
