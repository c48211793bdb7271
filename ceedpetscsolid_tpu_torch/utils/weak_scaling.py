"""Rank-count sweeps of the distributed Newton driver: the port's
counterpart of the JAX package's scripts/weak_scaling.py.

    python -m ceedpetscsolid_tpu_torch.utils.weak_scaling [--ranks 1,2,4]
        [--backend nccl|gloo] [--series jax,card,unstructured,invariance]
        [--reps 5] [--profile] [--out PATH] [--quick] [--device cpu]

Series (faces of the unit box; n ranks):
  jax           the JAX tool's box series: hyperFS degree 3, nu 0.3, E 1,
                -test, faces (24, 24, 4n), one increment, p-MG [1, 2, 3]
                with the replicated AMG coarse solve: 2,304 elements a rank
  card          the same at the reference's degree-4 flagship width a
                card: degree 4, faces (16, 16, 16n), p-MG [1, 2, 4] + AMG:
                4,096 elements a rank
  unstructured  the role of the JAX tool's cylinder pair: a scrambled
                HEX27 box (mesh/scrambled.py) with faces (8, 8, 11n), 704
                elements a rank, written as an Exodus-II file and read back
                through Config.mesh_file (reordered as -mesh is); hyperFS
                degree 3, E 1e6, no forcing, side sets 998 (x = 0,
                translated by (0, -0.02, 0.05)) and 999 (x = 1) clamped;
                n = 1 and 4 only, as the pair
  invariance    the n = 1 unstructured file at degree 2, two increments,
                p-MG + AMG (every level at the fine quadrature, as the
                distributed driver integrates them), solved to Newton rtol
                1e-5 in float32 (1e-8 in float64) on n ranks against the
                serial ElasticityProblem.solve on the same device
The three weak series run a fixed-work Newton step (parallel/tasks.
fixed_step: ksp_rtol 0 and ksp_max_it 10, as the JAX tool) `--reps` times;
a point whose CG stopped before 10 iterations did not do the fixed work
and fails its check. --quick shrinks the faces to (2, 2, 4n), (2, 2, 4n)
and (2, 2, 3n) for the CPU tests.

Prints one JSON line per point (every number with the card's name and
power limit), one summary line per series (weak: E(n) = t_step(1) /
t_step(n) from the median steps, DoF/s a card = DoF x 10 / t_step / n,
whether the per-rank halo is constant within 5% for n > 1; invariance:
SNES, KSP, |u - u_serial| / |u_serial| and the solve wall, with the
strong-scaling speedup wall(1) / wall(n)), and writes every record to
--out (default build/weak_scaling/weak_scaling.json). Exits 1 when a check
failed, after printing everything.

Ranks are spawned by parallel/launch.run: NCCL puts rank r on cuda:r (n
above the card count is skipped, and said so), gloo puts every rank on the
given device. Step times are the host's clock around a synchronised step,
the maximum over ranks; exchange seconds are the device's under NCCL and
the host's under gloo ("clock"). Several gloo ranks on one card measure
staging through host memory, not scaling. The device is CUDA unless
--device cpu is given; without a CUDA device the sweep raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import torch

SERIES = ("jax", "card", "unstructured", "invariance")
WEAK = SERIES[:3]
KSP_ITS = 10                 # the JAX tool's fixed CG work a Newton step
HALO_SLACK = 1.05            # the JAX tool's box_halo_constant
UNSTRUCTURED_RANKS = (1, 4)  # the JAX tool's cylinder pair: one mesh a side
SEED = 0                     # scrambled_box_mesh's seed
# fused-apply launch paths (fused_apply.COUNTS.by_path): a batch that ran
# on any other path ran the plain version
KERNEL_PATHS = {"bulk", "async", "generic", "generic_gmem", "generic_cluster"}
CLAMP = dict(forcing="none", bc_clamp=(998, 999),
             bc_clamp_translate={998: (0.0, -0.02, 0.05)})
REPO = Path(__file__).resolve().parents[2]
OUT_DIR = REPO / "build" / "weak_scaling"


def faces(series: str, n: int, quick: bool = False) -> tuple:
    """Box faces of a weak series' point at n ranks (the invariance series
    takes the unstructured series' n = 1 mesh)."""
    if series == "invariance":
        return faces("unstructured", 1, quick)
    full = {"jax": (24, 24, 4), "card": (16, 16, 16), "unstructured": (8, 8, 11)}
    # small faces whose stretched elements keep p-MG + AMG from reaching
    # ksp_rtol 0's 1e-10 in float64 within 10 CG iterations at every n
    small = {"jax": (2, 2, 4), "card": (2, 2, 4), "unstructured": (2, 2, 3)}
    a, b, c = (small if quick else full)[series]
    return (a, b, c * n)


def exodus_file(f: tuple, directory) -> Path:
    """The scrambled HEX27 box of faces `f` as an Exodus-II file in
    `directory` (written anew: it is made from SEED), side sets 998 at
    x = 0 and 999 at x = 1: faces that keep their element size as n grows
    the mesh along z, so the clamp's shift strains the same at every n."""
    from ..mesh.scrambled import faces_on, scrambled_box_mesh, \
        write_exodus_hex27

    path = Path(directory) / f"scrambled_{f[0]}x{f[1]}x{f[2]}_hex27.exo"
    path.parent.mkdir(parents=True, exist_ok=True)
    mesh = scrambled_box_mesh(f, SEED)
    write_exodus_hex27(path, mesh, {998: faces_on(mesh, 0, 0.0),
                                    999: faces_on(mesh, 0, 1.0)})
    return path


def weak_config(series: str, n: int, dtype, directory,
                quick: bool = False) -> dict:
    """Config keyword arguments (device aside) of a weak series' point."""
    fixed = dict(problem="hyperFS", nu=0.3, num_increments=1,
                 multigrid="logarithmic", ksp_rtol=0.0, ksp_max_it=KSP_ITS,
                 dtype=dtype)
    f = faces(series, n, quick)
    if series in ("jax", "card"):
        return dict(fixed, degree=3 if series == "jax" else 4, E=1.0,
                    test_mode=True, box_faces=f)
    if series == "unstructured":
        return dict(fixed, degree=3, E=1e6,
                    mesh_file=str(exodus_file(f, directory)), **CLAMP)
    raise ValueError(f"{series!r} is not a weak series: {WEAK}")


def invariance_config(dtype, directory, quick: bool = False) -> dict:
    f32 = dtype == torch.float32
    return dict(problem="hyperFS", degree=2, nu=0.3, E=1e6,
                mesh_file=str(exodus_file(faces("invariance", 1, quick),
                                          directory)),
                num_increments=2, multigrid="logarithmic",
                coarse_solve="amg", level_quadrature="fine",
                ksp_rtol=1e-6 if f32 else 1e-10, dtype=dtype, **CLAMP)


def newton_rtol(dtype) -> float:
    """The invariance solves' Newton rtol: chip_smoke's DIST_RTOL in
    float32, DistributedProblem.solve's default in float64."""
    return 1e-5 if dtype == torch.float32 else 1e-8


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def run_point(config: dict, jobs, world: int, backend: str, device, store,
              in_process: bool = False):
    """parallel/tasks.problem_task on `world` ranks: spawned by launch.run,
    or (one rank, in_process) in this process, whose modules the rank's
    JAX check then covers."""
    from ..parallel import launch, tasks

    if not in_process:
        return launch.run(tasks.problem_task, world, backend, device, store,
                          args=(config, jobs))
    import torch.distributed as tdist

    if world != 1:
        raise ValueError("in_process runs one rank")
    launch.check_backend(backend, 1, device)
    os.makedirs(store, exist_ok=True)
    path = os.path.join(store, f"filestore_{uuid.uuid4().hex}")
    tdist.init_process_group(backend, store=tdist.FileStore(path, 1),
                             rank=0, world_size=1)
    try:
        return tasks.problem_task(0, 1, launch.rank_device(backend, device, 0),
                                  config, jobs)
    finally:
        tdist.destroy_process_group()
        if os.path.exists(path):
            os.remove(path)


def launches_ok(counts: list) -> bool:
    """Every rank's batches ran the fused kernel: launches by kernel paths
    only, once per batch apply, in both modes."""
    return all(set(p for _, p in c["by_path"]) <= KERNEL_PATHS
               and all(c["launches"][m] == c["batch_applies"][m] > 0
                       for m in ("residual", "jacobian"))
               for c in counts)


def weak_point(series: str, n: int, backend: str, device, store,
               reps: int = 5, profile: bool = False, quick: bool = False,
               dtype=None, in_process: bool = False, card_name=None) -> dict:
    """One weak series' point: the fixed_step job on n ranks -> its
    record (see the module docstring)."""
    from ..device import default_dtype

    dtype = dtype or default_dtype(torch.device(device))
    cfg = weak_config(series, n, dtype, Path(store).parent / "meshes", quick)
    out = run_point(cfg, [("fixed_step", {"reps": reps, "profile": profile})],
                    n, backend, device, store, in_process)
    fs, halo = out["fixed_step"], out["halo"]
    steps = [1e3 * t for t in fs["step_s"]]
    counts = out["fixed_step_counts"]
    return {
        "series": series, "n": n, "backend": backend,
        "card": card_name or card(device), "dtype": str(dtype),
        "faces": list(faces(series, n, quick)), "degree": cfg["degree"],
        "dofs": fs["dofs"], "elements": int(sum(fs["elements"])),
        "elements_per_rank": fs["elements"], "owned_per_rank": fs["owned"],
        "halo_per_rank": halo["ghosts_per_shard"],
        "halo_max": halo["max_ghosts"],
        "halo_max_bytes_f32": halo["max_ghosts"] * 3 * 4,
        "ksp_its": fs["iters"], "cg_reason": fs["cg_reason"],
        "fixed_work": all(i == KSP_ITS for i in fs["iters"]),
        "step_ms": steps, "step_ms_min": min(steps),
        "step_ms_median": statistics.median(steps),
        "step_ms_max": max(steps),
        "clock": fs["clock"],
        "exchange_ms": {k: 1e3 * v / reps for k, v in fs["exchange_s"].items()},
        "setup_s": fs["setup_s"][0],
        "setup_s_max": {k: max(r.get(k, 0.0) for r in fs["setup_s"])
                        for k in fs["setup_s"][0]},
        "problem_s": [s["problem_s"] for s in out["setup"]],
        "distributed_s": [s["distributed_s"] for s in out["setup"]],
        "launches": [{"residual": c["launches"]["residual"],
                      "jacobian": c["launches"]["jacobian"],
                      "batch_applies": c["batch_applies"],
                      "by_path": {f"{m} {p}": k
                                  for (m, p), k in c["by_path"].items()}}
                     for c in counts],
        "fused_only": launches_ok(counts),
        "profile": fs["profile"],
        "rnorm_in": fs["rnorm_in"], "rnorm": fs["rnorm"],
    }


def weak_summary(records: list) -> dict:
    """E(n), DoF/s a card and the per-rank halo test of one weak series'
    records (E needs the n = 1 point)."""
    by_n = {r["n"]: r for r in records}
    t1 = by_n[1]["step_ms_median"] if 1 in by_n else None
    halos = [r["halo_max"] for r in records if r["n"] > 1]
    return {
        "series": records[0]["series"], "card": records[0]["card"],
        "backend": records[0]["backend"],
        "points": [{"n": n, "dofs": r["dofs"],
                    "step_ms_median": r["step_ms_median"],
                    "efficiency": (t1 / r["step_ms_median"]
                                   if t1 is not None else None),
                    "dofs_per_s_card": (r["dofs"] * KSP_ITS
                                        / (r["step_ms_median"] * 1e-3) / n)}
                   for n, r in sorted(by_n.items())],
        "halo_constant": (not halos
                          or max(halos) <= HALO_SLACK * min(halos)),
        "fixed_work": all(r["fixed_work"] for r in records),
    }


def invariance_serial(cfg: dict, device) -> tuple[dict, np.ndarray]:
    """The serial ElasticityProblem.solve of the invariance mesh on
    `device`: (its record, u as float64 numpy (3, N))."""
    from ..problem import Config, ElasticityProblem
    from .timing import sync

    prob = ElasticityProblem(Config(**cfg, device=device))
    prob.config.newton.rtol = newton_rtol(prob.dtype)
    sync(prob.device)
    t0 = time.perf_counter()
    info = prob.solve()
    sync(prob.device)
    wall = time.perf_counter() - t0
    return ({"snes": info.snes_iters, "ksp": info.ksp_iters,
             "rnorm": float(info.rnorm), "converged": bool(info.converged),
             "dofs": info.dofs, "elements": prob.mesh.num_elements,
             "wall_s": wall},
            info.u.double().cpu().numpy())


def invariance_point(cfg: dict, n: int, backend: str, device, store,
                     serial: dict, u_serial: np.ndarray,
                     in_process: bool = False, card_name=None) -> dict:
    """The distributed solve of the invariance mesh on n ranks against the
    serial one."""
    rtol = newton_rtol(cfg["dtype"])
    out = run_point(cfg, [("solve", {"rtol": rtol})], n, backend, device,
                    store, in_process)
    s, u = out["solve"]["info"], out["solve"]["u"].astype(np.float64)
    return {
        "series": "invariance", "n": n, "backend": backend,
        "card": card_name or card(device), "dtype": str(cfg["dtype"]),
        "dofs": int(u.size), "halo_max": out["halo"]["max_ghosts"],
        "snes": s["newton_iters"], "ksp": s["ksp_iters"],
        "rnorm": s["rnorm"], "converged": s["converged"],
        "rel_du": float(np.linalg.norm(u - u_serial)
                        / np.linalg.norm(u_serial)),
        "wall_s": s["wall_s"], "step_s": s["step_seconds"],
        "pc_s": s["pc_seconds"], "exchange_s": s["exchange_seconds"],
        "clock": "device" if backend == "nccl" else "host",
        "stage_s": s["stage_seconds"],
        "fused_only": launches_ok(out["solve_counts"]),
        "serial": serial, "u": u,
    }


def invariance_summary(records: list) -> dict:
    by_n = {r["n"]: r for r in records}
    w1 = by_n[1]["wall_s"] if 1 in by_n else None
    return {"series": "invariance", "card": records[0]["card"],
            "backend": records[0]["backend"], "serial": records[0]["serial"],
            "points": [{"n": n, "snes": r["snes"], "ksp": r["ksp"],
                        "rnorm": r["rnorm"], "rel_du": r["rel_du"],
                        "wall_s": r["wall_s"],
                        "speedup": w1 / r["wall_s"] if w1 else None}
                       for n, r in sorted(by_n.items())]}


def weak_failures(rec: dict, on_card: bool) -> list[str]:
    """What a weak point's checks found wrong (nothing: [])."""
    tag = f"{rec['series']} n = {rec['n']}"
    bad = []
    if not rec["fixed_work"]:
        bad.append(f"{tag}: CG ran {rec['ksp_its']} iterations "
                   f"({rec['cg_reason']}), not {KSP_ITS}: not the fixed work")
    if on_card and not rec["fused_only"]:
        bad.append(f"{tag}: a batch ran without the fused kernel")
    return bad


def invariance_failures(rec: dict, tol: float, on_card: bool) -> list[str]:
    """The invariance checks: the serial SNES, KSP within +2 (the
    distributed dot products sum in another order), u within tol."""
    ser, tag = rec["serial"], f"invariance n = {rec['n']}"
    bad = []
    if not (rec["converged"] and rec["snes"] == ser["snes"]
            and rec["ksp"] <= ser["ksp"] + 2 and rec["rel_du"] <= tol):
        bad.append(f"{tag}: SNES {rec['snes']} / serial {ser['snes']}, KSP "
                   f"{rec['ksp']} / {ser['ksp']}, |du| / |u| "
                   f"{rec['rel_du']:.2e} (tolerance {tol:g}), converged "
                   f"{rec['converged']}")
    if on_card and not rec["fused_only"]:
        bad.append(f"{tag}: a batch ran without the fused kernel")
    return bad


def invariance_tol(dtype) -> float:
    """u against the serial solve: chip_smoke's DIST_TOL in float32."""
    return 1e-5 if dtype == torch.float32 else 1e-10


def _line(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="1,2,4",
                    help="rank counts, comma-separated")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--series", default=",".join(SERIES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="rank 0's device split of one step a point")
    ap.add_argument("--out", type=Path, default=OUT_DIR / "weak_scaling.json")
    ap.add_argument("--quick", action="store_true",
                    help="small faces, for the CPU tests")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    series = args.series.split(",")
    unknown = set(series) - set(SERIES)
    if unknown:
        ap.error(f"unknown series {sorted(unknown)}: choose from {SERIES}")
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): the sweep "
            "runs on the GPU unless the CPU is asked for with --device cpu")
    from .. import native
    from ..device import default_dtype, select_device

    dev = select_device(args.device or "cuda")
    dtype = default_dtype(dev)
    on_card = dev.type == "cuda"
    ranks = [int(r) for r in args.ranks.split(",")]
    have = torch.cuda.device_count() if on_card else 0
    if args.backend == "nccl":
        skipped = [n for n in ranks if n > have]
        ranks = [n for n in ranks if n <= have]
        if skipped:
            print(f"weak_scaling: n = {skipped} skipped: NCCL runs one rank "
                  f"a card and this machine has {have}", flush=True)
    # built once here, before the ranks load them
    native.build()
    if on_card:
        from ..ops import fused_apply as fa

        fa._library()
    name = card(dev)
    store = args.out.parent / "store"
    records, summaries, failures = [], [], []
    for s in series:
        if s == "invariance":
            cfg = invariance_config(dtype, store.parent / "meshes",
                                    args.quick)
            serial, u_ser = invariance_serial(cfg, dev)
            _line({"series": "invariance", "serial": serial, "card": name})
            recs = []
            for n in ranks:
                rec = invariance_point(cfg, n, args.backend, dev.type, store,
                                       serial, u_ser, card_name=name)
                rec.pop("u")
                _line(rec)
                recs.append(rec)
                failures += invariance_failures(rec, invariance_tol(dtype),
                                                on_card)
            summary = invariance_summary(recs) if recs else None
        else:
            recs = []
            for n in ranks:
                if s == "unstructured" and n not in UNSTRUCTURED_RANKS:
                    continue
                rec = weak_point(s, n, args.backend, dev.type, store,
                                 args.reps, args.profile, args.quick, dtype,
                                 card_name=name)
                _line(rec)
                recs.append(rec)
                failures += weak_failures(rec, on_card)
            summary = weak_summary(recs) if recs else None
            if summary and not summary["halo_constant"] and s != "unstructured":
                failures.append(f"{s}: the per-rank halo is not constant "
                                f"for n > 1")
        records += recs
        if summary:
            _line({"summary": summary})
            summaries.append(summary)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": name, "records": records,
                                    "summaries": summaries,
                                    "failures": failures}, indent=1) + "\n")
    for f in failures:
        print(f"weak_scaling: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
