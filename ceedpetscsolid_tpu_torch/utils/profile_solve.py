"""Device profile of the hyperFS degree-4 solve: Jacobi CG against p-MG CG.

    python -m ceedpetscsolid_tpu_torch.utils.profile_solve [--box 16]
        [--coarse chebyshev|amg|both] [--out DIR]

The problem is chip_smoke.py's phases 6, 7 and 11: hyperFS degree 4 on a
box^3 box, -test, one increment, float32, ksp_rtol 1e-6; p-MG with
logarithmic levels, native level quadrature and the Chebyshev coarse solve
(--coarse chebyshev, the default), the AMG coarse solve (--coarse amg; its
refresh split is printed too), or both. For each preconditioner it runs
one solve to warm up (kernel build,
allocator), one solve without the profiler (the wall clock the busy share
is taken against) and one under torch.profiler. It prints, per solve: the
device kernels launched, their summed device time, the busy share (device
time over the unprofiled solve wall), and the kernels with the most
launches and the most device time. With --out it also writes the
profiler's own table per preconditioner. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

import torch

from ..problem import Config, ElasticityProblem, select_device

TOP = 8


def make_problem(box: int, multigrid: str, device, dtype=torch.float32,
                 level_quadrature="native", coarse_solve="chebyshev",
                 problem="hyperFS", degree=4,
                 f32_tolerances=None) -> ElasticityProblem:
    """One -test increment on a box^3 box (chip_smoke.py's solves and this
    profile): hyperFS degree 4 with the Chebyshev coarse solve unless told
    otherwise. Tolerances: the CLI's float32 ones (ksp and Newton rtol
    1e-6) when f32_tolerances, else 1e-10 (None: by the dtype)."""
    f32 = (dtype == torch.float32 if f32_tolerances is None
           else f32_tolerances)
    cfg = Config(problem=problem, degree=degree, nu=0.3, E=1.0,
                 test_mode=True, box_faces=(box,) * 3, multigrid=multigrid,
                 coarse_solve=coarse_solve,
                 level_quadrature=level_quadrature, num_increments=1,
                 device=device, dtype=dtype, ksp_rtol=1e-6 if f32 else 1e-10)
    if f32:
        cfg.newton.rtol = 1e-6              # the CLI's float32 policy
    return ElasticityProblem(cfg)


def device_events(prof):
    """(name, device us) of every operation the profiler saw on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == cuda]


def profile(prob: ElasticityProblem) -> dict:
    prob.solve()                            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = prob.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the unprofiled solve's AMG refresh split (element matrices, d2h,
    # native setup, upload)
    amg = dict(prob.amg_times) if prob._use_amg else None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prob.solve()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    evs = device_events(prof)
    copies = [(n, t) for n, t in evs if n.startswith(("Memcpy", "Memset"))]
    kernels = [(n, t) for n, t in evs if not n.startswith(("Memcpy",
                                                           "Memset"))]
    count, dev_us = collections.Counter(), collections.Counter()
    for n, t in kernels:
        count[n] += 1
        dev_us[n] += t
    device_ms = sum(t for _, t in evs) * 1e-3
    avgs = prof.key_averages()
    sort_key = ("self_device_time_total"          # torch >= 2.4
                if avgs and hasattr(avgs[0], "self_device_time_total")
                else "self_cuda_time_total")
    return {
        "snes": info.snes_iters, "ksp": info.ksp_iters, "amg_refresh_s": amg,
        "solve_s": wall, "pc_setup_s": info.pc_time,
        "profiled_solve_s": wall_prof,
        "kernel_launches": len(kernels), "copies": len(copies),
        "device_ms": device_ms, "busy_share": device_ms * 1e-3 / wall,
        "launches_per_ksp": len(kernels) / max(info.ksp_iters, 1),
        "top_by_launches": [(n[:60], c, dev_us[n] * 1e-3)
                            for n, c in count.most_common(TOP)],
        "top_by_device_ms": [(n[:60], count[n], t * 1e-3)
                             for n, t in dev_us.most_common(TOP)],
        "table": avgs.table(sort_by=sort_key, row_limit=40),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--box", type=int, default=16)
    ap.add_argument("--coarse", choices=("chebyshev", "amg", "both"),
                    default="chebyshev",
                    help="coarse solve of the p-MG preconditioner")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solve: no CUDA device", file=sys.stderr)
        return 2
    dev = select_device("cuda")
    summary = {}
    runs = [("jacobi", "none", "chebyshev")]
    if args.coarse in ("chebyshev", "both"):
        runs.append(("pmg", "logarithmic", "chebyshev"))
    if args.coarse in ("amg", "both"):
        runs.append(("pmg_amg", "logarithmic", "amg"))
    for tag, mg, coarse in runs:
        r = profile(make_problem(args.box, mg, dev, coarse_solve=coarse))
        table = r.pop("table")
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / f"profile_{tag}_{args.box}.txt").write_text(table)
        print(f"[{tag}] hyperFS p4 {args.box}^3 float32: SNES {r['snes']}, "
              f"KSP {r['ksp']}, solve {r['solve_s']:.4f} s (pc setup "
              f"{r['pc_setup_s']:.4f} s; profiled {r['profiled_solve_s']:.4f}"
              f" s)")
        if r["amg_refresh_s"]:
            print(f"    AMG refresh split, s: {r['amg_refresh_s']}")
        print(f"    {r['kernel_launches']} kernel launches "
              f"({r['launches_per_ksp']:.1f} per CG iteration), "
              f"{r['copies']} copies/memsets, device time {r['device_ms']:.3f}"
              f" ms, busy share {r['busy_share']:.4f}")
        for key in ("top_by_launches", "top_by_device_ms"):
            print(f"    {key}:")
            for n, c, ms in r[key]:
                print(f"      {c:7d} launches {ms:9.3f} ms  {n}")
        summary[tag] = {k: v for k, v in r.items() if not k.startswith("top")}
    print(json.dumps(summary))
    if min(r["kernel_launches"] for r in summary.values()) < 1:
        print("profile_solve: the profiler recorded no device kernels",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
