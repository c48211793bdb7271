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
in float32. Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
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
    amp = 3e-3 / box
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


def compare_case(libs, f, q, u, v, physics, phys) -> list[dict]:
    """Residual and J.v of one physics on one factory: both libraries'
    outputs held against each other, then timed in turns."""
    pw = fa.pointwise(physics)
    conn, b = f.restr.conn, f.basis
    dt, dev = u.dtype, u.device
    nelem = conn.shape[0]
    _, st = fa.residual_plain(u, conn, q, b, phys, pw)
    rows = []
    for mode, jac, x in (("residual", False, u), ("jacobian", True, v)):
        st_in = st if jac else None
        outs = {}
        for name, lib in libs.items():
            ve = torch.empty((3, nelem, b.P3), dtype=dt, device=dev)
            so = (torch.empty((9, nelem, b.Q3), dtype=dt, device=dev)
                  if pw.stash and not jac else st_in)
            fa._launch(jac, x, conn, q, b, so, ve, phys, pw, lib=lib)
            outs[name] = (ve, so if not jac else None, so)
        torch.cuda.synchronize()
        ok = agree(outs["this"][0], outs["parent"][0])
        if outs["parent"][1] is not None:
            ok = ok and agree(outs["this"][1], outs["parent"][1])
        times = {"parent": [], "this": []}
        for name in ("parent", "this", "this", "parent"):
            ve, _, so = outs[name]
            lib = libs[name]
            times[name].append(cuda_device_ms(
                lambda: fa._launch(jac, x, conn, q, b, so, ve, phys, pw,
                                   lib=lib), reps=20, inner=10))
        t = {k: sum(v_) / len(v_) for k, v_ in times.items()}
        bound, by = fa.bound_ms(pw, mode, b.P, b.Q, nelem,
                                f.space.num_nodes, dt)
        p = fa.plan(jac, q, b, st_in, pw, lib=libs["this"])
        rows.append({
            "physics": pw.name, "mode": mode, "P": b.P, "Q": b.Q,
            "dtype": str(dt).removeprefix("torch."), "nelem": nelem,
            "parent_ms": t["parent"], "ms": t["this"],
            "turns_ms": times, "bound_ms": bound, "bound_by": by,
            "parent_share": bound / t["parent"], "share": bound / t["this"],
            "agree": ok, "tile_elems": p.elems, "smem": p.smem,
            "path": p.path})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--box", type=int, default=24)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_fused: no CUDA device", file=sys.stderr)
        return 2
    import ctypes

    dev = torch.device("cuda")
    out = BUILD_DIR.parent / "compare"
    parent_csrc = renamed_source(
        args.parent / "ceedpetscsolid_tpu_torch" / "csrc", out / "src")
    # a source from before the generic tile has no units of its own for it
    generic = "CPS_FUSED_GENERIC" in (parent_csrc / "fused_apply.cu").read_text()
    units = tuple(u for u in FUSED_UNITS
                  if generic or not any("GENERIC" in f for f in u[1]))
    path, _ = build(parent_csrc, out, units)
    parent = ctypes.CDLL(str(path))
    this = fa._library()
    parent.cps_fused_apply.argtypes = this.cps_fused_apply.argtypes
    parent.cps_fused_apply.restype = ctypes.c_int
    libs = {"parent": parent, "this": this}
    card = card_line()
    print(f"card: {card}; parent {args.parent}")
    phys = Physics(nu=0.3, E=1.0)
    rows = []
    for dt in (torch.float32, torch.float64):
        for physics in PHYSICS:
            q1d = 1 if physics.endswith("pressure") else None
            f, q, u, v = inputs(args.box, 4, dt, dev, q1d=q1d)
            rows += compare_case(libs, f, q, u, v, physics, phys)
            del f, q, u, v
            torch.cuda.empty_cache()
    for P, Q in PQ_LESS:
        f, q, u, v = inputs(PQ_LESS_BOX, P - 1, torch.float32, dev,
                            qextra=Q - P)
        rows += compare_case(libs, f, q, u, v, "hyperFS", phys)
    print(f"device ms, parent / this (mean of two turns each), bound from "
          f"shapes and share of it ({card}):")
    for r in rows:
        print(f"  {r['physics']:24s} ({r['P']},{r['Q']}) {r['dtype']:7s} "
              f"{r['mode']:8s} nelem {r['nelem']:6d}: parent "
              f"{r['parent_ms']:.4f}  this {r['ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  share "
              f"{r['parent_share']:.3f} -> {r['share']:.3f}  tile "
              f"{r['tile_elems']} x{r['smem']} B {r['path']}  "
              f"{'agree' if r['agree'] else 'DIFFER'}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "rows": rows},
                                        indent=1))
    if not all(r["agree"] for r in rows):
        print("compare_fused: the two kernels disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
