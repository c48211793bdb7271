"""Closed loop of whole solves on one card: each request is
`ElasticityProblem.solve()` from u = 0 (every load increment, Newton with
the configuration's preconditioner rebuilt each Newton step), one caller.

Traffic parameters: warm_requests (solves in set-up), trace_requests (the
first solves of the window traced in a --trace 1 run), check_requests
(solves of the window compared with the reference, a sample drawn from the
seed, the last one always among them).

End-to-end: solve_s, the window's wall over the solves completed in it
(back to back, each ending in the program's device sync). Correct: every
sampled solve's displacement leaves at most the limit of the start's
residual, by the float64 reference (reference/checks.residual_ratio).
"""

from __future__ import annotations

import time

import numpy as np

from .. import common
from ..reference import checks, fem
from ..trace import Tracer


def run(r: common.Run) -> dict:
    import torch

    from ceedpetscsolid_tpu_torch.problem import ElasticityProblem

    cfg, tr = r.cell.config, r.cell.traffic
    dev = torch.device(r.device)
    faces, verts = common.seeded_mesh(cfg, r.seed)
    prob = ElasticityProblem(common.port_config(cfg, dev),
                             mesh=common.port_mesh(faces, verts))
    for _ in range(tr["warm_requests"]):
        info = prob.solve()
        if not info.converged:
            raise RuntimeError(f"the set-up's solve did not converge: "
                               f"{info.reason}")
    setup_s = time.time() - r.t_start

    keep = common.reservoir(np.random.default_rng(r.seed),
                            tr["check_requests"] - 1)
    kept, records, last = {}, [], None
    tracer = Tracer(dev) if r.trace else None
    trace = None
    t0 = time.perf_counter()
    while True:
        i = len(records)
        traced = tracer is not None
        if traced and i == 0:
            tracer.start()
        ts = time.perf_counter()
        info = prob.solve()
        te = time.perf_counter()
        if tracer is not None and i + 1 == tr["trace_requests"]:
            trace = tracer.stop(i + 1)
            tracer = None
        rec = {"wall_s": te - ts, "solve_s": info.solve_time,
               "pc_s": info.pc_time, "snes": info.snes_iters,
               "ksp": info.ksp_iters, "converged": info.converged,
               "traced": traced}
        if getattr(prob, "amg_times", None) is not None:
            rec["amg_s"] = dict(prob.amg_times)
        records.append(rec)
        slot = keep(i)
        if slot is not None:
            kept[slot] = (i, info.u)
        last = (i, info.u)
        if te - t0 >= r.seconds:
            break
    if tracer is not None:
        trace = tracer.stop(len(records))
    window_s = te - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    samples = dict(kept.values())
    samples[last[0]] = last[1]
    samples = {i: u.detach().to("cpu", torch.float64).numpy()
               for i, u in samples.items()}
    nodes = prob.fine_space.num_nodes
    del prob, info, kept, last
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    judge = checks.SolveJudge(fem.HyperFSReference(
        fem.BoxSpace(faces, cfg["degree"], verts), cfg["E"], cfg["nu"], dev))
    worst = max(judge.residual_ratio(u) for u in samples.values())
    n = len(records)
    return {
        "setup_s": setup_s, "window_s": window_s, "attempted": n,
        "failed": sum(not rec["converged"] for rec in records),
        "e2e": {"solve_s": window_s / n},
        "memory_peak_bytes": int(peak), "records": records, "trace": trace,
        "shapes": shapes(cfg, nodes),
        "checks": {"residual": [worst, r.cell.limits["residual"]["limit"]]},
    }


def shapes(cfg: dict, fine_nodes: int) -> dict:
    """The fused J.v launches' shapes by (P, Q): every p-multigrid level
    of the box at its native quadrature and at the fine one (the readers
    take the shapes the trace shows)."""
    nx, ny, nz = cfg["box_faces"]
    nelem = nx * ny * nz
    p = cfg["degree"]
    degs = [p]
    if cfg["multigrid"] == "logarithmic":
        degs = sorted({min(2 ** i, p) for i in range(p.bit_length() + 1)})
    Qf = p + 1 + cfg["qextra"]
    out = {}
    for d in degs:
        nodes = (d * nx + 1) * (d * ny + 1) * (d * nz + 1)
        for Q in {d + 1 + cfg["qextra"], Qf}:
            out[f"{d + 1},{Q}"] = {"nelem": nelem, "nodes": nodes}
    return {"dtype": cfg["dtype"], "jv": out, "fine_nodes": fine_nodes}
