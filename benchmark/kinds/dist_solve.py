"""Closed loop of whole distributed solves: the configuration's `ranks`
rank processes (parallel/launch.run: NCCL, one card a rank, on CUDA; gloo
ranks on the CPU), each holding its part of the box
(parallel/driver.DistributedProblem over the program's block partition),
one caller. Each request is `DistributedProblem.solve()` from u = 0 on
every rank in lockstep: every Newton step the p-MG set-up and the AMG
refresh, V-cycles with the replicated AMG coarse solve, the halo
exchanges and the all-reduces of CG.

Traffic parameters: warm_requests (solves in set-up), trace_requests (the
first solves of the window traced on rank 0 in a --trace 1 run),
check_requests (solves of the window compared with the reference, a
sample drawn from the seed, the last one always among them).

Rank 0's clock opens and ends the window: after each solve one tiny
collective, outside the solve, tells the others whether to go on.
End-to-end: solve_s, the window's wall over the solves completed in it
(each ending in the answer's all-gather, which waits for every rank's
device). Correct: every sampled solve's global displacement leaves at
most the limit of the start's residual, judged by rank 0 on the float64
reference of the whole box (reference/checks.residual_ratio).

What rank 0 sends back: its requests (wall, SNES, KSP, converged, traced,
and the program's own request record where the program keeps one: its
spans and counters, utils/timing; then also the solve's, the
preconditioner set-up's and the AMG refresh's seconds under the names
the one-card cell's records give them, so that its readers read these
too), its trace, its local fused J.v shapes, the largest memory peak of
the ranks and the checks. Where the program counts them, every request
of the window refreshes the AMG on the device at every preconditioner
build after the first native one (amg.device_refreshes = pc.builds), or
the run fails.
"""

from __future__ import annotations

import time

import numpy as np

from .. import common
from ..reference import checks, fem
from ..trace import Tracer


def run(r: common.Run, patch=None) -> dict:
    """The cell on its ranks. patch(rank): called first on every rank (the
    CPU tests plant faults with it)."""
    from ceedpetscsolid_tpu_torch import native
    from ceedpetscsolid_tpu_torch.parallel import launch

    cuda = r.device != "cpu"
    native.build()
    if cuda:
        # built once here, not by every rank at once
        from ceedpetscsolid_tpu_torch.ops import fused_apply

        fused_apply._library()
    cell = r.cell
    store = common.ROOT / "build" / "bench_cache" / "dist_solve"
    return launch.run(
        _rank, int(cell.config["ranks"]), "nccl" if cuda else "gloo",
        r.device, store,
        args=(cell.config, cell.traffic, cell.limits["residual"]["limit"],
              r.seed, r.seconds, r.trace, r.t_start, patch))


def _shapes(dp, cfg: dict) -> dict:
    """Rank 0's fused J.v launches by (P, Q): each level's interior and
    boundary batches (elements, nodes they touch), every level at the fine
    quadrature."""
    import torch

    Q = cfg["degree"] + 1 + cfg["qextra"]
    spaces = dp.problem.spaces[-len(dp.levels):]
    out = {}
    for space, lv in zip(spaces, dp.levels):
        out[f"{space.degree + 1},{Q}"] = [
            {"nelem": int(c.shape[0]), "nodes": int(torch.unique(c).numel())}
            for c in (lv.ra.conn_int, lv.ra.conn_bnd) if c.shape[0]]
    return {"dtype": cfg["dtype"], "jv": out}


def _program_record(seen: int):
    """The program's record of the solve just run (utils/timing), without
    its profiled span list; None where the program keeps none."""
    try:
        from ceedpetscsolid_tpu_torch.utils.timing import records
    except ImportError:
        return None
    recs = records()
    if not recs or recs[-1]["name"] != "solve" or recs[-1]["id"] <= seen:
        return None
    return {k: v for k, v in recs[-1].items() if k != "spans"}


def _request(wall_s: float, info: dict, traced: bool, program) -> dict:
    """One request's record; with the program's record, its solve, pc and
    AMG refresh seconds as the one-card cell's records give them
    (kinds/solve.py)."""
    rec = {"wall_s": wall_s, "snes": info["newton_iters"],
           "ksp": info["ksp_iters"], "converged": bool(info["converged"]),
           "traced": traced, "program": program}
    if program is not None:
        secs, counts = program["seconds"], program["counts"]
        dev, builds = (counts.get("amg.device_refreshes"),
                       counts.get("pc.builds"))
        if dev != builds:
            raise RuntimeError(f"a solve of the window refreshed its AMG on "
                               f"the device {dev} times in {builds} "
                               f"preconditioner builds")
        rec.update(solve_s=secs["solve"], pc_s=secs.get("pc", 0.0),
                   amg_s={k: v for k, v in secs.items()
                          if k.startswith("pc/amg/")})
    return rec


def _last_id() -> int:
    try:
        from ceedpetscsolid_tpu_torch.utils.timing import records
    except ImportError:
        return -1
    recs = records()
    return recs[-1]["id"] if recs else -1


def _rank(rank, world, dev, cfg, tr, limit, seed, seconds, trace, t_start,
          patch):
    import torch
    import torch.distributed as tdist

    from ceedpetscsolid_tpu_torch.parallel.driver import DistributedProblem
    from ceedpetscsolid_tpu_torch.problem import ElasticityProblem

    if patch is not None:
        patch(rank)
    faces, verts = common.seeded_mesh(cfg, seed)
    prob = ElasticityProblem(common.port_config(cfg, dev),
                             mesh=common.port_mesh(faces, verts))
    dp = DistributedProblem(prob)
    rtol = cfg["newton_rtol"]
    for _ in range(tr["warm_requests"]):
        _, info = dp.solve(rtol=rtol)
        if not info["converged"]:
            raise RuntimeError(f"the set-up's solve did not converge: "
                               f"{info['reason']}")
    flag = torch.zeros(1, device=dev)
    tdist.all_reduce(flag)
    setup_s = time.time() - t_start

    keep = common.reservoir(np.random.default_rng(seed),
                            tr["check_requests"] - 1)
    kept, reqs, last = {}, [], None
    tracer = Tracer(dev) if trace and rank == 0 else None
    trace_out = None
    t0 = time.perf_counter()
    while True:
        i = len(reqs)
        traced = tracer is not None
        if traced and i == 0:
            tracer.start()
        seen = _last_id()
        ts = time.perf_counter()
        u, info = dp.solve(rtol=rtol)
        te = time.perf_counter()
        if tracer is not None and i + 1 == tr["trace_requests"]:
            trace_out = tracer.stop(i + 1)
            tracer = None
        reqs.append(_request(te - ts, info, traced, _program_record(seen)))
        if rank == 0:
            slot = keep(i)
            if slot is not None:
                kept[slot] = (i, u)
            last = (i, u)
        # rank 0's clock ends the window
        flag.fill_(float(rank == 0 and te - t0 >= seconds))
        tdist.broadcast(flag, src=0)
        if flag.item():
            break
    if tracer is not None:
        trace_out = tracer.stop(len(reqs))
    window_s = te - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    shapes = _shapes(dp, cfg)
    every = [None] * world
    tdist.all_gather_object(every, (peak, common.forbidden_modules()))
    bad = sorted({m for _, b in every for m in b})
    if bad:
        raise RuntimeError(f"a rank process holds {bad}")
    if rank != 0:
        return None

    samples = dict(kept.values())
    samples[last[0]] = last[1]
    del dp, prob, kept, last, u
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judge = checks.SolveJudge(fem.HyperFSReference(
        fem.BoxSpace(faces, cfg["degree"], verts), cfg["E"], cfg["nu"], dev))
    worst = max(judge.residual_ratio(u) for u in samples.values())
    n = len(reqs)
    return {
        "setup_s": setup_s, "window_s": window_s, "attempted": n,
        "failed": sum(not q["converged"] for q in reqs),
        "e2e": {"solve_s": window_s / n},
        "memory_peak_bytes": int(max(p for p, _ in every)), "records": reqs,
        "trace": trace_out, "shapes": shapes,
        "checks": {"residual": [worst, limit]},
    }
