#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ceedpetscsolid_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the fused-apply CUDA kernel from the checkout's sources;
  3. kernel vs its plain torch version on the same inputs: hyperFS degree 4
     on a 24^3 box (13,824 elements, 2,738,019 DoF), and degrees 2 and 3 on
     a 4^3 box and on the scrambled (unstructured-numbering) 4^3 box.
     float64 kernel vs float64 plain: max|diff| <= 1e-12 max|ref|;
     float32 kernel vs float64 plain: |diff| <= 2e-5 |ref| + 1e-6 max|ref|
     (float32 rounding alone reaches ~6e-7 max|ref| in the plain version);
  4. CUDA-event times (median of 20 calls after warm-up) of kernel and plain
     version, residual and J.v, at the 24^3 degree-4 shapes, in float32;
  5. the reference smoke flags in hyperFS form through cli.main, checked
     against the JAX package's result on the same flags;
  6. the main path: hyperFS degree 4 on a 16^3 box (823,875 DoF), -test,
     -multigrid none, one increment, float32, through ElasticityProblem;
     kernel launch counters are reset just before and read just after, and
     a float64 twin of the same solve checks the float32 answer.
Then one JSON line of per-kernel results, the card line, and as the last
line {"ok": true, "device": {...}}. Without a CUDA device, or without the
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

import numpy as np

# JAX package, f64 on the CPU, for the phase-5 flags (rc, MMS rel-L2);
# tests/test_torch_problem.py re-checks the port against it on every run.
SMOKE_FLAGS = ["-problem", "hyperFS", "-test", "-degree", "3", "-nu", "0.3",
               "-E", "1", "-dm_plex_box_faces", "3,3,3", "-multigrid", "none",
               "-num_steps", "1"]
SMOKE_REF_RC, SMOKE_REF_L2 = 1, 6.21859e-02
TPU_KERNEL = "ceedpetscsolid_tpu/ops/pallas_apply.py:172"
KERNEL_BOX, SOLVE_BOX = 24, 16       # elements per side: phases 3-4, phase 6
CU_SOURCE = "ceedpetscsolid_tpu_torch/csrc/fused_apply.cu"
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


def time_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def make_case(mesh, degree, dtype, device, seed):
    """Factory, qdata and seeded inputs u, v on `device`. The amplitude
    shrinks with the element size so gradu stays ~1e-2 on every mesh, as
    with the 1e-3 inputs on the 3^3 boxes of tests/test_pallas_apply.py
    (rough inputs at O(1) strain make C nearly singular, where any change
    of rounding order is amplified)."""
    import torch

    from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
    from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory

    f = OperatorFactory(build_fespace(mesh, degree), dtype=dtype,
                        device=device)
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


def check_kernel(label, mesh, degree, device, phys):
    """Kernel vs plain on one mesh/degree, f64 and f32; returns the f32
    max abs errors (residual ve, J.v)."""
    import torch

    from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
    from ceedpetscsolid_tpu_torch.ops.basis import Basis3D

    f, q, u, v = make_case(mesh, degree, torch.float64, device, seed=degree)
    conn, b64 = f.restr.conn, f.basis
    ve0, st0 = fa.residual_plain(u, conn, q, b64, phys)
    jv0 = fa.jacobian_plain(v, conn, q, st0, b64, phys)
    ve, st = fa.residual(u, conn, q, b64, phys)
    jv = fa.jacobian(v, conn, q, st0, b64, phys)
    torch.cuda.synchronize()
    for nm, a, b in (("residual ve", ve, ve0), ("stash", st, st0),
                     ("J.v ve", jv, jv0)):
        compare(f"{label} f64 {nm}", a, b, True)
    f32 = torch.float32
    b32 = Basis3D.create(b64.P, b64.Q, "gauss", f32, device)
    q32 = q.to(f32)
    ve, st = fa.residual(u.to(f32), conn, q32, b32, phys)
    jv = fa.jacobian(v.to(f32), conn, q32, st0.to(f32), b32, phys)
    torch.cuda.synchronize()
    e_r = compare(f"{label} f32 residual ve", ve, ve0, False)
    compare(f"{label} f32 stash", st, st0, False)
    e_j = compare(f"{label} f32 J.v ve", jv, jv0, False)
    return e_r, e_j


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
    from ceedpetscsolid_tpu_torch import cli
    from ceedpetscsolid_tpu_torch.csrc.build import build
    from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
    from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh
    from ceedpetscsolid_tpu_torch.models import Physics
    from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
    from ceedpetscsolid_tpu_torch.problem import (Config, ElasticityProblem,
                                                  select_device)

    dev = select_device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    # ---- 1. card --------------------------------------------------------
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib, ptx = build()
    log(f"[2] kernel build {time.perf_counter() - t0:.1f} s -> {lib.name}")
    for line in ptx.splitlines():
        if re.search(r"Used \d+ registers|spill", line):
            log("    " + line.strip())

    # ---- 3. kernel vs plain ---------------------------------------------
    phys = Physics(nu=0.3, E=1.0)
    log("[3] kernel vs plain version")
    n = KERNEL_BOX
    errs = check_kernel(f"{n}^3 p4 box", box_mesh((n, n, n)), 4, dev, phys)
    for deg in (2, 3):
        check_kernel(f"4^3 p{deg} box", box_mesh((4, 4, 4)), deg, dev, phys)
        check_kernel(f"4^3 p{deg} scrambled", scrambled_box_mesh((4, 4, 4), 4),
                     deg, dev, phys)
    if FAILED:
        raise AssertionError(f"kernel disagrees with plain version: {FAILED}")

    # ---- 4. times at the 24^3 degree-4 shapes, float32 ----------------------
    f, q, u, v = make_case(box_mesh((n, n, n)), 4, torch.float32, dev, 4)
    conn, b = f.restr.conn, f.basis
    _, st = fa.residual_plain(u, conn, q, b, phys)
    ndof = 3 * f.space.num_nodes
    res_op = f.make_residual_structured(phys)
    jac_op = f.make_jacobian_structured(phys)
    times = {
        "residual": time_ms(lambda: fa.residual(u, conn, q, b, phys)),
        "residual_plain": time_ms(lambda: fa.residual_plain(u, conn, q, b, phys)),
        "jacobian": time_ms(lambda: fa.jacobian(v, conn, q, st, b, phys)),
        "jacobian_plain": time_ms(
            lambda: fa.jacobian_plain(v, conn, q, st, b, phys)),
        "residual_operator": time_ms(lambda: res_op(u, q)),
        "jacobian_operator": time_ms(lambda: jac_op(v, q, st)),
    }
    log(f"[4] times at {n}^3 p4, float32, {ndof} DoF ({card})")
    for k, t in times.items():
        log(f"    {k:20s} {t:9.4f} ms  {1e-3 * ndof / t:10.1f} MDoF/s")
    del f, q, u, v, st, res_op, jac_op
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

    # ---- 6. main path: 16^3 degree-4 hyperFS solve, float32 ----------------
    def solve(dtype):
        f32 = dtype == torch.float32
        cfg = Config(problem="hyperFS", degree=4, nu=0.3, E=1.0,
                     test_mode=True, box_faces=(SOLVE_BOX,) * 3, multigrid="none",
                     num_increments=1, device=dev, dtype=dtype,
                     ksp_rtol=1e-6 if f32 else 1e-10)
        if f32:
            cfg.newton.rtol = 1e-6          # the CLI's float32 policy
        prob = ElasticityProblem(cfg)
        return prob, prob.solve()

    fa.COUNTS.reset()
    prob, info = solve(torch.float32)
    launches = {"residual": fa.COUNTS.residual_launches,
                "jacobian": fa.COUNTS.jacobian_launches}
    err = prob.mms_error(info.u)
    energy = prob.strain_energy(info.u)
    log(f"[6] hyperFS p4 {SOLVE_BOX}^3 float32: {info.dofs} DoF, setup "
        f"{prob.setup_time:.2f} s")
    log(f"    converged {info.converged} ({info.reason}), SNES "
        f"{info.snes_iters}, KSP {info.ksp_iters}, rnorm {info.rnorm:.3e}")
    log(f"    solve {info.solve_time:.3f} s (Jacobi diagonal builds "
        f"{info.pc_time:.3f} s), {info.mdofs_per_sec:.2f} MDoF/s "
        f"(1e-6 dofs KSP / time) ({card})")
    log(f"    MMS rel-L2 {err:.6e}, strain energy {energy:.10e}")
    log(f"    kernel launches: residual {launches['residual']}, "
        f"jacobian {launches['jacobian']}")
    _, stash = prob._nonlinear_residual(info.u, prob.bc_values(1.0), prob.F)
    t_mv = time_ms(lambda: prob._jacobian_action(info.u, stash))
    per_it = info.solve_time / max(info.ksp_iters, 1) * 1e3
    log(f"    J.v operator {t_mv:.4f} ms vs {per_it:.4f} ms wall per KSP "
        "iteration (the rest: vector ops, Newton/line search, host syncs)")
    if not info.converged or not math.isfinite(err):
        raise AssertionError("float32 main-path solve did not converge")
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    prob64, info64 = solve(torch.float64)
    err64 = prob64.mms_error(info64.u)
    en64 = prob64.strain_energy(info64.u)
    du = float(torch.linalg.norm(info.u.double() - info64.u)
               / torch.linalg.norm(info64.u))
    log(f"    float64 twin: SNES {info64.snes_iters}, KSP {info64.ksp_iters},"
        f" MMS rel-L2 {err64:.6e}, energy {en64:.10e}, |u32-u64|/|u64| "
        f"{du:.3e}")
    if not (info64.converged and du <= 1e-3
            and abs(err - err64) <= 1e-3 * err64
            and abs(energy - en64) <= 1e-3 * abs(en64)):
        raise AssertionError("float32 solve disagrees with its float64 twin")

    kernels = [
        {"name": f"fused_apply_{mode}", "route": "cuda", "source": CU_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[mode],
         "max_abs_err": e, "ms": times[mode], "plain_ms": times[mode + "_plain"]}
        for mode, e in (("residual", errs[0]), ("jacobian", errs[1]))
    ]
    log(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
