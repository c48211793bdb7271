"""The fused element apply against another commit's, on the same card.

    python -m ceedpetscsolid_tpu_torch.utils.compare_fused --parent DIR
        [--box 24] [--json FILE]

DIR is a checkout of another commit (`git archive <commit> | tar -x -C
DIR`), or a directory holding only a variant's
`ceedpetscsolid_tpu_torch/csrc/fused_apply.cu`. That source is built by
this checkout's csrc/build.py into build/compare/, its C++ namespace
renamed: two builds whose kernels share their names fail at their first
launch in one process (CUDA error 1 on an H100). Both export
the same C entry point, cps_fused_apply. For every physics and mode at box^3, degree 4 (the
pressure term at (P, Q) = (5, 1)), in float32 and float64, on the same
inputs, it:
  * holds each library's output against the other's: float64 to 1e-12 of
    max|ref|, float32 to 2e-5 |ref| + 1e-6 max|ref|;
  * times the device's work (utils.timing.cuda_device_ms) in turns:
    parent, this, this, parent; a time is the mean of its two turns;
  * prints both times beside the bound from shapes (fused_apply.bound_ms)
    and each one's share of it.
Then the P < Q instances (2, 5), (3, 5), (5, 6) of hyperFS on the 16^3 box
in float32. Then the generic tile at the shapes where the solves launch it
(GENERIC_SHAPES: the pressure term at (5, 2), (3, 2), (2, 2) on the 8^3 box,
phase 14 of chip_smoke.py, and at (5, 2) on 24^3; hyperFS at (7, 7) on the
6^3 box, phase 15, and on 12^3), both modes, float32 and float64, each
library's launch plan printed beside its time (elements a tile, tiles,
threads, shared memory, path); then HIGH_SHAPES, where phase 19's solves
launch it above P, Q = 8 (hyperFS (15, 15) f32 on 5^3, (12, 12) f64 on
6^3 and their (9, 9) levels), each in its own dtype, with this library's
cluster body also timed at the fewest CTAs a cluster, twice and four
times as many (within 8) in the same turns (the cluster size passed to
cps_fused_apply). `--generic` runs these alone, `--high` HIGH_SHAPES
alone. A parent whose cps_fused_apply predates the cluster-size argument
keeps its own argument list. `--solve`
adds an end-to-end turn: chip_smoke.py phase 14's problem (hyperFSIncomp,
degree 4, -qextra 1, the 8^3 clamp, p-MG + AMG, float32), its clamped face
translated by SOLVE_SHIFT of the box, solved with each library's kernels
in turns (parent, this, this, parent): solve seconds, SNES and KSP counts,
energy. Needs a CUDA device; prints the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..csrc.build import BUILD_DIR, FUSED_UNITS, build
from ..mesh.box import box_mesh
from ..mesh.fespace import build_fespace
from ..models import Physics
from ..ops import fused_apply as fa
from ..ops.operator import OperatorFactory
from .timing import cuda_device_ms

PHYSICS = ("hyperFS", "linElas", "hyperSS", "hyperFSIncomp",
           "hyperFSIncomp-pressure")
PQ_LESS = ((2, 5), (3, 5), (5, 6))
PQ_LESS_BOX = 16
# (physics, P, Q, box): the generic tile where the solves launch it
GENERIC_SHAPES = (("hyperFSIncomp-pressure", 5, 2, 8),
                  ("hyperFSIncomp-pressure", 3, 2, 8),
                  ("hyperFSIncomp-pressure", 2, 2, 8),
                  ("hyperFSIncomp-pressure", 5, 2, 24),
                  ("hyperFS", 7, 7, 6),
                  ("hyperFS", 7, 7, 12))
# (physics, P, Q, box, dtype): the generic tile above P, Q = 8 where phase
# 19's solves launch it
HIGH_SHAPES = (("hyperFS", 15, 15, 5, torch.float32),
               ("hyperFS", 12, 12, 6, torch.float64),
               ("hyperFS", 9, 9, 5, torch.float32),
               ("hyperFS", 9, 9, 6, torch.float64))
# --solve's clamp translation, a hundredth of the box: at chip_smoke.py's
# 0.05 a float32 solve takes ~100 s on the H100 (128 Newton steps), and
# --solve runs four
SOLVE_SHIFT = 0.01


def renamed_source(csrc: Path, out: Path) -> Path:
    """A copy of csrc/fused_apply.cu in `out` whose namespace cps is
    cps_parent; returns the directory."""
    src = (csrc / "fused_apply.cu").read_text()
    src = src.replace("namespace cps {", "namespace cps_parent {")
    src = src.replace("cps::", "cps_parent::")
    out.mkdir(parents=True, exist_ok=True)
    dst = out / "fused_apply.cu"
    if not dst.exists() or dst.read_text() != src:
        dst.write_text(src)
    return out


def parent_units(src: str) -> tuple:
    """The fused-apply units that `src` builds: this checkout's units a
    (physics, P) and the entry unit; for the generic tile none in a
    source from before it, one a physics in one from before its bodies,
    else one a (physics, body) for each body its `GenericBody` enum names
    (which need not be this checkout's)."""
    units = [u for u in FUSED_UNITS
             if not any("GENERIC" in f for f in u[1])]
    if "CPS_FUSED_GENERIC" in src:
        bodies = sorted({int(b) for b in re.findall(r"\bkBody\w+ = (\d+)",
                                                      src)})
        for pw in fa.PHYSICS.values():
            flags = (*FUSED_UNITS[0][1], f"-DCPS_FUSED_GENERIC={pw.kernel_id}")
            if "CPS_GENERIC_BODY" not in src:
                units.append(("fused_apply.cu", flags))
            else:
                units += [("fused_apply.cu",
                           (*flags, f"-DCPS_GENERIC_BODY={b}"))
                          for b in bodies]
    return tuple(units)


class OlderApply:
    """A library whose cps_fused_apply takes no cluster size (a commit
    before the cluster body), called as fused_apply._launch calls this
    one's: the last argument dropped."""

    def __init__(self, lib):
        self.lib = lib
        self.cps_fused_plan = lib.cps_fused_plan

    def cps_fused_apply(self, *args):
        return self.lib.cps_fused_apply(*args[:-1])


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        "nvidia-smi failed"


def inputs(box: int, degree: int, dtype, device, qextra=0, q1d=None):
    """Factory, qdata, u and v (strains ~1e-2, numpy seeded) on the card."""
    f = OperatorFactory(build_fespace(box_mesh((box,) * 3), degree),
                        qextra=qextra, dtype=dtype, device=device, q1d=q1d)
    rng = np.random.default_rng(degree)
    # above the register bodies' cap / (P / 5)^2: a random nodal field's
    # gradient grows with P^2
    P = degree + 1
    amp = 3e-3 / box * ((5 / P) ** 2 if P > fa.GENERIC_REG_CAP else 1.0)
    u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes))
                            * amp, dtype=dtype, device=device)
            for _ in range(2))
    return f, f.compute_qdata(), u, v


def agree(got, ref) -> bool:
    err = (got.double() - ref.double()).abs()
    mx = float(ref.abs().max())
    if ref.dtype == torch.float64:
        return float(err.max()) <= 1e-12 * mx
    return bool((err <= 2e-5 * ref.double().abs() + 1e-6 * mx).all())


@contextlib.contextmanager
def library(lib):
    """Every fused apply of the package launches `lib`'s kernels."""
    saved = fa._library
    fa._library = lambda: lib
    try:
        yield
    finally:
        fa._library = saved


def solve_turns(libs, device) -> dict:
    """Phase 14's problem with each library in turns: name -> list of
    (solve seconds, SNES, KSP, strain energy)."""
    from ..problem import Config, ElasticityProblem

    out = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        cfg = Config(problem="hyperFSIncomp", degree=4, qextra=1, nu=0.49,
                     E=1e6, forcing="none", bc_clamp=(6, 5),
                     bc_clamp_translate={5: (SOLVE_SHIFT, 0.0, 0.0)},
                     num_increments=1, multigrid="logarithmic",
                     nu_smoother=0.3, box_faces=(8, 8, 8), device=device,
                     dtype=torch.float32, ksp_rtol=1e-6)
        cfg.newton.rtol = 1e-6
        with library(libs[name]):
            p = ElasticityProblem(cfg)
            info = p.solve()
        out[name].append((info.solve_time, info.snes_iters, info.ksp_iters,
                          p.strain_energy(info.u)))
    return out


def plan_text(p: fa.Plan) -> str:
    return (f"{p.elems} el x {p.tiles} tiles, {p.threads} thr, {p.smem} B, "
            f"{p.path}" + (f" {p.body}" if p.body else "")
            + (f" {p.copy}" if p.copy else "")
            + (f" k={p.cluster} x {p.clusters} clusters" if p.cluster
               else ""))


def cluster_sizes(P: int, Q: int, dtype) -> tuple:
    """The cluster body's sizes to time at (P, Q): the fewest CTAs that
    fit, twice and four times as many, within 8 (none for another body)."""
    if fa.generic_body(P, Q, dtype) != 6:
        return ()
    k0 = fa.cluster_fewest(P, Q, dtype.itemsize)
    return tuple(k for k in (k0, 2 * k0, 4 * k0) if k <= fa.CLUSTER_MAX)


def compare_case(libs, f, q, u, v, physics, phys, ks=()) -> list[dict]:
    """Residual and J.v of one physics on one factory: both libraries'
    outputs held against each other, then timed in turns; `ks`: cluster
    sizes at which this library is also run and timed ("this k=N")."""
    pw = fa.pointwise(physics)
    conn, b = f.restr.conn, f.basis
    dt, dev = u.dtype, u.device
    nelem = conn.shape[0]
    _, st = fa.residual_plain(u, conn, q, b, phys, pw)
    variants = {"parent": (libs["parent"], 0), "this": (libs["this"], 0),
                **{f"this k={k}": (libs["this"], k) for k in ks}}
    rows = []
    for mode, jac, x in (("residual", False, u), ("jacobian", True, v)):
        st_in = st if jac else None
        outs = {}
        for name, (lib, k) in variants.items():
            ve = torch.empty((3, nelem, b.P3), dtype=dt, device=dev)
            so = (torch.empty((9, nelem, b.Q3), dtype=dt, device=dev)
                  if pw.stash and not jac else st_in)
            fa._launch(jac, x, conn, q, b, so, ve, phys, pw, lib=lib,
                       cluster=k)
            outs[name] = (ve, so if not jac else None, so)
        torch.cuda.synchronize()
        ok = True
        for name in variants:
            if name != "parent":
                ok = ok and agree(outs[name][0], outs["parent"][0])
                if outs["parent"][1] is not None:
                    ok = ok and agree(outs[name][1], outs["parent"][1])
        times = {name: [] for name in variants}
        for name in [*variants, *reversed(variants)]:
            ve, _, so = outs[name]
            lib, k = variants[name]
            times[name].append(cuda_device_ms(
                lambda: fa._launch(jac, x, conn, q, b, so, ve, phys, pw,
                                   lib=lib, cluster=k), reps=20, inner=10))
        t = {k: sum(v_) / len(v_) for k, v_ in times.items()}
        bound, by = fa.bound_ms(pw, mode, b.P, b.Q, nelem,
                                f.space.num_nodes, dt)
        plans = {name: fa.plan(jac, q, b, st_in, pw, lib=lib)
                 for name, lib in libs.items()}
        p = plans["this"]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        planes = 19 if jac and pw.stash else 10
        by_k = {k: {"ms": t[f"this k={k}"], "share": bound / t[f"this k={k}"],
                    "smem": fa.generic_plan(b.P, b.Q, dt, nelem, sms, planes,
                                            k).smem}
                for k in ks}
        rows.append({
            "physics": pw.name, "mode": mode, "P": b.P, "Q": b.Q,
            "dtype": str(dt).removeprefix("torch."), "nelem": nelem,
            "parent_ms": t["parent"], "ms": t["this"],
            "turns_ms": times, "bound_ms": bound, "bound_by": by,
            "parent_share": bound / t["parent"], "share": bound / t["this"],
            "agree": ok, "tile_elems": p.elems, "smem": p.smem,
            "path": p.path, "box": round(nelem ** (1 / 3)),
            "cluster": p.cluster, "clusters": p.clusters, "by_k": by_k,
            "plans": {k: plan_text(v) for k, v in plans.items()}})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--box", type=int, default=24)
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--generic", action="store_true",
                    help="only the generic tile at GENERIC_SHAPES and "
                    "HIGH_SHAPES")
    ap.add_argument("--high", action="store_true",
                    help="only the generic tile at HIGH_SHAPES")
    ap.add_argument("--solve", action="store_true",
                    help="add phase 14's solve with each library in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_fused: no CUDA device", file=sys.stderr)
        return 2
    import ctypes

    dev = torch.device("cuda")
    out = BUILD_DIR.parent / "compare"
    parent_csrc = renamed_source(
        args.parent / "ceedpetscsolid_tpu_torch" / "csrc", out / "src")
    path, _ = build(parent_csrc, out, parent_units(
        (parent_csrc / "fused_apply.cu").read_text()))
    parent = ctypes.CDLL(str(path))
    this = fa._library()
    older = "int cluster)" not in (parent_csrc / "fused_apply.cu").read_text()
    parent.cps_fused_apply.argtypes = this.cps_fused_apply.argtypes[
        :-1 if older else None]
    parent.cps_fused_apply.restype = ctypes.c_int
    parent.cps_fused_plan.argtypes = this.cps_fused_plan.argtypes
    parent.cps_fused_plan.restype = ctypes.c_int
    libs = {"parent": OlderApply(parent) if older else parent, "this": this}
    card = card_line()
    print(f"card: {card}; parent {args.parent}")
    phys = Physics(nu=0.3, E=1.0)
    rows = []
    only = args.generic or args.high
    for dt in () if args.high else (torch.float32, torch.float64):
        for physics in () if only else PHYSICS:
            q1d = 1 if physics.endswith("pressure") else None
            f, q, u, v = inputs(args.box, 4, dt, dev, q1d=q1d)
            rows += compare_case(libs, f, q, u, v, physics, phys)
            del f, q, u, v
            torch.cuda.empty_cache()
    for P, Q in () if only else PQ_LESS:
        f, q, u, v = inputs(PQ_LESS_BOX, P - 1, torch.float32, dev,
                            qextra=Q - P)
        rows += compare_case(libs, f, q, u, v, "hyperFS", phys)
    for dt in () if args.high else (torch.float32, torch.float64):
        for physics, P, Q, box in GENERIC_SHAPES:
            f, q, u, v = inputs(box, P - 1, dt, dev, q1d=Q)
            rows += compare_case(libs, f, q, u, v, physics, phys)
            del f, q, u, v
            torch.cuda.empty_cache()
    for physics, P, Q, box, dt in HIGH_SHAPES:
        f, q, u, v = inputs(box, P - 1, dt, dev, q1d=Q)
        rows += compare_case(libs, f, q, u, v, physics, phys,
                             cluster_sizes(P, Q, dt))
        del f, q, u, v
        torch.cuda.empty_cache()
    print(f"device ms, parent / this (mean of two turns each), bound from "
          f"shapes and share of it ({card}):")
    for r in rows:
        print(f"  {r['physics']:24s} ({r['P']},{r['Q']}) {r['dtype']:7s} "
              f"{r['mode']:8s} {r['box']}^3: parent "
              f"{r['parent_ms']:.4f}  this {r['ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  share "
              f"{r['parent_share']:.3f} -> {r['share']:.3f}  "
              f"{'agree' if r['agree'] else 'DIFFER'}")
        print(f"      plan parent: {r['plans']['parent']}; this: "
              f"{r['plans']['this']}")
        for k, x in r["by_k"].items():
            print(f"      this at k={k}: {x['ms']:.4f} ms, share "
                  f"{x['share']:.3f}, {x['smem']} B a CTA")
    solves = None
    if args.solve:
        solves = solve_turns(libs, dev)
        print(f"phase 14's solve, shift {SOLVE_SHIFT}, float32 "
              f"({card}): (solve s, SNES, KSP, energy) in turns")
        for name, runs in solves.items():
            for t, snes, ksp, w in runs:
                print(f"  {name:6s} {t:.3f} s  SNES {snes}  KSP {ksp}  "
                      f"energy {w:.10e}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "rows": rows,
                                         "solves": solves}, indent=1))
    if not all(r["agree"] for r in rows):
        print("compare_fused: the two kernels disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
