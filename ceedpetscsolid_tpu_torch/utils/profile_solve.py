"""Device profile of the hyperFS solve: Jacobi CG against p-MG CG.

    python -m ceedpetscsolid_tpu_torch.utils.profile_solve [--box 16]
        [--degree 4] [--dtype float32|float64]
        [--coarse chebyshev|amg|both] [--out DIR]

The problem is chip_smoke.py's phases 6, 7 and 11: hyperFS degree 4 on a
box^3 box, -test, one increment, float32, ksp_rtol 1e-6 (float64: 1e-10);
--degree 14 --box 5 and --degree 11 --box 6 --dtype float64 are phase
19's (the generic tile's cluster body on the fine level); p-MG with
logarithmic levels, native level quadrature and the Chebyshev coarse solve
(--coarse chebyshev, the default), the AMG coarse solve (--coarse amg; its
refresh split is printed too), or both. For each preconditioner it runs
one solve to warm up (kernel build,
allocator), one solve without the profiler and one under torch.profiler.
It prints, per solve: the device kernels launched, their summed device
time, the fused element apply's launches and device ms per mode (residual,
J.v), and the kernels with the most launches and the most device time.
With --out it also writes the profiler's own table per preconditioner.
Needs a CUDA device.

`step_split` reduces one profiled step: device time by kernel family and
by program span (utils/timing: the kernels launched inside each span, the
device's idle time under each).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import time
from pathlib import Path

import torch

from ..problem import Config, ElasticityProblem, select_device
from .timing import RECORDER

TOP = 8
# a fused-apply kernel's name: cps::<body>_kernel<physics, jacobian, P, Q, T>,
# cps::generic_cluster_kernel<physics, jacobian, T> (and generic_gmem_kernel),
# or cps::generic_reg_kernel<physics, jacobian, T, body>
FUSED = re.compile(
    r"cps::\w+_kernel<\d+, (true|false), (?:(\d+), (\d+), )?\w+(?:, \d+)?>")
# the span of the distributed V-cycle's replicated AMG coarse solve
# (parallel/driver.py), the serial V-cycle's coarse span's name
AMG_SCOPE = "vcycle/coarse"
# step_split's label of idle time that no program span covers
NO_SPAN = "(no span)"


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


def kernel_family(name: str) -> str:
    """The family of a device operation by its name: "fused residual
    (P,Q)" / "fused J.v (P,Q)" ("(generic)" where P, Q are set at run
    time), "NCCL", "copies" (memcpy, memset), else "other"."""
    m = FUSED.search(name)
    if m:
        mode = "J.v" if m.group(1) == "true" else "residual"
        pq = f"({m.group(2)},{m.group(3)})" if m.group(2) else "(generic)"
        return f"fused {mode} {pq}"
    if "nccl" in name.lower():
        return "NCCL"
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    return "other"


def _in_scope(event, label: str, prefix: bool = False) -> bool:
    """Whether `event` or an operation around it is named `label` (or,
    with prefix, starts with it)."""
    while event is not None:
        if event.name.startswith(label) if prefix else event.name == label:
            return True
        event = event.cpu_parent
    return False


# the CUDA runtime calls of the host side of a step, by what the host does
# in them: wait for the device, launch a kernel, copy
HOST_CALLS = {"sync": ("Synchronize",), "launch": ("LaunchKernel",),
              "copy": ("Memcpy", "Memset")}
# the host's torch.distributed calls (their whole span, the enqueue of the
# NCCL kernel included)
COLLECTIVES = "c10d::"


def _innermost(event, spans):
    """The name of the innermost program span around a host event, or
    NO_SPAN."""
    while event is not None:
        if event.name in spans:
            return event.name
        event = event.cpu_parent
    return NO_SPAN


def _idle_by_span(host, busy, t0: float, t1: float) -> dict:
    """{span: us} of the gaps of [t0, t1] that the sorted, merged device
    intervals `busy` leave, each by the innermost of the sorted (start,
    end, name) program spans `host` that covers its middle."""
    gaps, at = [], t0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    out = collections.defaultdict(float)
    stack, i = [], 0
    for a, b in gaps:
        t = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[stack[-1][2] if stack else NO_SPAN] += b - a
    return out


def step_split(prof, wall_s: float, step_s: float, spans=None) -> dict:
    """Device time of one profiled step by family (kernel_family):
    {family: {"launches", "ms"}}, and by program span ("spans": the
    kernels launched inside each span's innermost, and "idle_ms", the
    device's idle time under it, NO_SPAN where none covers it); the summed
    device ms, the busy ms (the union of the device intervals: NCCL runs
    beside the compute stream), the kernel launches, the profiled step's
    wall ms and the busy share of `step_s`, the unprofiled step's wall;
    "host": {kind: {"calls", "ms"}} of the CUDA runtime calls by
    HOST_CALLS and of the outermost torch.distributed calls
    ("collectives"). spans: the program span names (default: every one
    this process entered under the profiler, utils/timing)."""
    spans = RECORDER.profiled_names if spans is None else set(spans)
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    evs = [e for e in events if e.device_type == cuda
           and e.name not in spans
           and not getattr(e, "is_user_annotation", False)]
    fam = collections.defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in evs:
        row = fam[kernel_family(e.name)]
        row[0] += 1
        row[1] += e.time_range.elapsed_us() * 1e-3
        intervals.append((e.time_range.start, e.time_range.end))
    by_span = collections.defaultdict(lambda: [0, 0.0, 0.0])
    host_spans = []
    for e in events:
        if e.device_type == cuda:
            continue
        if e.name in spans:
            host_spans.append((e.time_range.start, e.time_range.end, e.name))
        for k in e.kernels:
            row = by_span[_innermost(e, spans)]
            row[0] += 1
            row[1] += k.duration * 1e-3
    busy = []
    for a, b in sorted(intervals):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    busy_ms = sum(b - a for a, b in busy) * 1e-3
    stamps = [t for e in events for t in (e.time_range.start,
                                          e.time_range.end)]
    if stamps:
        for name, us in _idle_by_span(sorted(host_spans), busy, min(stamps),
                                      max(stamps)).items():
            by_span[name][2] += us * 1e-3
    host = {k: [0, 0.0] for k in (*HOST_CALLS, "collectives")}
    for e in events:
        if e.device_type == cuda:
            continue
        kind = None
        if e.name.startswith(COLLECTIVES):
            if not _in_scope(e.cpu_parent, COLLECTIVES, prefix=True):
                kind = "collectives"
        elif e.name.startswith("cu"):
            kind = next((k for k, keys in HOST_CALLS.items()
                         if any(x in e.name for x in keys)), None)
        if kind is not None:
            host[kind][0] += 1
            host[kind][1] += e.time_range.elapsed_us() * 1e-3
    return {"families": {k: {"launches": n, "ms": ms}
                         for k, (n, ms) in sorted(fam.items())},
            "spans": {k: {"launches": n, "ms": ms, "idle_ms": idle}
                      for k, (n, ms, idle) in sorted(by_span.items())},
            "host": {k: {"calls": n, "ms": ms} for k, (n, ms) in host.items()},
            "device_ms": sum(ms for _, ms in fam.values()),
            "busy_ms": busy_ms,
            "launches": sum(n for k, (n, _) in fam.items()
                            if k != "copies"),
            "wall_ms": wall_s * 1e3, "step_ms": step_s * 1e3,
            "busy_share": busy_ms * 1e-3 / step_s}


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
    fused = {"residual": [0, 0.0], "jacobian": [0, 0.0]}
    for n, t in kernels:
        m = FUSED.search(n)
        if m:
            row = fused["jacobian" if m.group(1) == "true" else "residual"]
            row[0] += 1
            row[1] += t * 1e-3
    avgs = prof.key_averages()
    sort_key = ("self_device_time_total"          # torch >= 2.4
                if avgs and hasattr(avgs[0], "self_device_time_total")
                else "self_cuda_time_total")
    return {
        "snes": info.snes_iters, "ksp": info.ksp_iters, "amg_refresh_s": amg,
        "solve_s": wall, "pc_setup_s": info.pc_time,
        "profiled_solve_s": wall_prof,
        "kernel_launches": len(kernels), "copies": len(copies),
        "device_ms": device_ms,
        "launches_per_ksp": len(kernels) / max(info.ksp_iters, 1),
        "fused_apply": {k: {"launches": c, "device_ms": ms}
                        for k, (c, ms) in fused.items()},
        "top_by_launches": [(n[:60], c, dev_us[n] * 1e-3)
                            for n, c in count.most_common(TOP)],
        "top_by_device_ms": [(n[:60], count[n], t * 1e-3)
                             for n, t in dev_us.most_common(TOP)],
        "table": avgs.table(sort_by=sort_key, row_limit=40),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--box", type=int, default=16)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
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
        r = profile(make_problem(args.box, mg, dev,
                                 getattr(torch, args.dtype),
                                 coarse_solve=coarse, degree=args.degree))
        table = r.pop("table")
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / f"profile_{tag}_{args.box}_p{args.degree}_"
             f"{args.dtype}.txt").write_text(table)
        print(f"[{tag}] hyperFS p{args.degree} {args.box}^3 {args.dtype}: "
              f"SNES {r['snes']}, "
              f"KSP {r['ksp']}, solve {r['solve_s']:.4f} s (pc setup "
              f"{r['pc_setup_s']:.4f} s; profiled {r['profiled_solve_s']:.4f}"
              f" s)")
        if r["amg_refresh_s"]:
            print(f"    AMG refresh split, s: {r['amg_refresh_s']}")
        print(f"    {r['kernel_launches']} kernel launches "
              f"({r['launches_per_ksp']:.1f} per CG iteration), "
              f"{r['copies']} copies/memsets, device time {r['device_ms']:.3f}"
              f" ms")
        print("    fused apply: " + ", ".join(
            f"{k} {v['launches']} launches {v['device_ms']:.3f} ms"
            for k, v in r["fused_apply"].items()))
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
