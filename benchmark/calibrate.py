"""Readings that a cell's limits are set from (not run by the benchmark's
own runs):

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds 2] [--out FILE]

For each of --seeds, the program's reading of every number the cell
compares: one run of the cell's driver with a short window, all in this
process. For each of --control-seeds, the control's reading of the same
number at the cell's own size: the reference put in the program's place,
computed in float32 with TF32 contractions (reference/fem.py precision
"tf32"), the step below the configuration's float32 with TF32 off, and
judged as the program is. Prints one JSON line a reading and writes them
all to --out.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import common
from .kinds import cg_solve
from .reference import checks, fem


def control_reading(cell: common.Cell, seed: int, device) -> dict:
    """The control's reading of the cell's compared number on `seed`."""
    import torch

    cfg, tr = cell.config, cell.traffic
    faces, verts = common.seeded_mesh(cfg, seed)
    space = fem.BoxSpace(faces, cfg["degree"], verts)
    ref32 = fem.HyperFSReference(space, cfg["E"], cfg["nu"], device,
                                 precision="tf32")
    t = time.perf_counter()
    if tr["kind"] == "solve":
        u = checks.newton(ref32, cfg["newton_rtol"], cfg["ksp_rtol"])
        del ref32
        judge = checks.SolveJudge(fem.HyperFSReference(
            space, cfg["E"], cfg["nu"], device))
        return {"residual": judge.residual_ratio(u),
                "seconds": time.perf_counter() - t}
    u_lin = torch.as_tensor(fem.mms_solution(space.coords).T.copy(),
                            dtype=torch.float32, device=device)
    b = cg_solve.rhs(ref32.mask, seed, 0, torch.float32, device)
    _, st32 = ref32.residual(u_lin)
    x, its = checks.cg(lambda v: ref32.jacobian(v, st32), b,
                       1.0 / ref32.diagonal(st32), rtol=cfg["ksp_rtol"])
    del ref32, st32
    ref = fem.HyperFSReference(space, cfg["E"], cfg["nu"], device)
    _, st = ref.residual(u_lin.double())
    return {"residual": checks.linear_residual(ref, st, b, x),
            "iterations": its, "seconds": time.perf_counter() - t}


def program_readings(cell: common.Cell, seeds, seconds: float, device):
    for seed in seeds:
        r = common.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                       t_start=time.time(), device=device)
        out = common.kind(cell.traffic["kind"]).run(r)
        recs = out["records"]
        yield {"seed": seed, **{k: v for k, (v, _) in out["checks"].items()},
               "requests": len(recs),
               "snes": sorted({x.get("snes") for x in recs} - {None}),
               "ksp": sorted({x["ksp"] for x in recs})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = common.load_cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    cseeds = [int(s) for s in a.control_seeds.split(",") if s]
    rows = []
    for row in program_readings(cell, seeds, a.seconds, a.device):
        row = {"side": "program", **row}
        print(json.dumps(row), flush=True)
        rows.append(row)
    dev = "cuda:0" if a.device == "cuda" else a.device
    for seed in cseeds:
        row = {"side": "control", "seed": seed,
               **control_reading(cell, seed, dev)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    for key in sorted({k for r in rows for k in r} & set(cell.limits)):
        for side in ("program", "control"):
            v = [r[key] for r in rows if r["side"] == side]
            if v:
                print(f"{key} {side}: min {min(v)!r} median "
                      f"{float(np.median(v))!r} max {max(v)!r} "
                      f"over {len(v)} seeds", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
