"""Closed loop of Jacobi CG solves on one card, the CEED bake-off
problems' shape: each request is the program's Jacobi-preconditioned CG
on the fine-level Jacobian, as `ElasticityProblem._linear_solve` runs it
under multigrid none, to the configuration's ksp_rtol (the natural norm,
as the reference's KSPCG), from a fresh right-hand side made from the seed
on the device (zero at the constrained DOFs).

The Jacobian is linearized at the manufactured solution u* at the nodes
(the state a -test solve converges to, made here, not by the program); the
program's residual at that state gives its stash, and its Jacobi diagonal
is built once in set-up, by the warm requests.

Traffic parameters: preconditioner_multigrid, warm_requests,
trace_requests, check_requests (as kinds/solve.py).

End-to-end: cg_mdofs_per_s = 1e-6 x DoFs x CG iterations completed in the
window / the window's wall. Correct: each sampled request's answer leaves
at most the limit of its right-hand side, ||b - J x|| / ||b|| by the
float64 reference (reference/checks.linear_residual).
"""

from __future__ import annotations

import time

import numpy as np

from .. import common
from ..reference import checks, fem
from ..trace import Tracer


def rhs(space_mask, seed: int, i: int, dtype, device):
    """Request i's right-hand side (3, N): standard normal, zero where
    `space_mask` (3, N) is set."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(common.request_seed(seed, i))
    b = torch.randn(tuple(space_mask.shape), generator=g, dtype=dtype,
                    device=device)
    return torch.where(space_mask, 0.0, b)


def run(r: common.Run) -> dict:
    import torch

    from ceedpetscsolid_tpu_torch.problem import ElasticityProblem

    cfg, tr = r.cell.config, r.cell.traffic
    dev = torch.device(r.device)
    faces, verts = common.seeded_mesh(cfg, r.seed)
    space = fem.BoxSpace(faces, cfg["degree"], verts)
    prob = ElasticityProblem(
        common.port_config(cfg, dev, multigrid=tr["preconditioner_multigrid"]),
        mesh=common.port_mesh(faces, verts))
    mask = prob.bc_mask
    # the linearization state, made here and handed to both sides
    u_lin = torch.as_tensor(fem.mms_solution(space.coords).T.copy(),
                            dtype=prob.dtype, device=dev)
    bc = prob.bc_values(1.0)
    _, stash = prob._nonlinear_residual(u_lin, bc, prob.F)

    def request(i):
        b = rhs(mask, r.seed, i, prob.dtype, dev)
        prob.cg_exits = {}
        x, n = prob._linear_solve(-b, stash, refresh=False)
        return x, n, "converged" in prob.cg_exits

    for w in range(tr["warm_requests"]):
        request(-1 - w)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
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
        x, n, ok = request(i)
        if tracer is not None and i + 1 == tr["trace_requests"]:
            trace = tracer.stop(i + 1)
            trace["cg_iterations"] = sum(rec["ksp"] for rec in records) + n
            tracer = None
        te = time.perf_counter()
        records.append({"ksp": n, "converged": ok, "traced": traced})
        slot = keep(i)
        if slot is not None:
            kept[slot] = (i, x, n)
        last = (i, x, n)
        if te - t0 >= r.seconds:
            break
    if tracer is not None:
        trace = tracer.stop(len(records))
        trace["cg_iterations"] = sum(rec["ksp"] for rec in records)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    samples = {i: (x, n) for i, x, n in kept.values()}
    samples[last[0]] = last[1:]
    samples = {i: (x.detach().to("cpu", torch.float64), n)
               for i, (x, n) in samples.items()}
    u_lin = u_lin.cpu()
    dofs = 3 * prob.fine_space.num_nodes
    rdtype = prob.dtype
    del prob, stash, kept, last, x, bc
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = fem.HyperFSReference(space, cfg["E"], cfg["nu"], dev)
    _, ref_stash = ref.residual(u_lin.to(dev, ref.dtype))
    worst = 0.0
    for i, (x, n) in samples.items():
        b = rhs(ref.mask, r.seed, i, rdtype, dev)
        worst = max(worst, checks.linear_residual(ref, ref_stash, b, x))
    total = sum(rec["ksp"] for rec in records)
    n_req = len(records)
    return {
        "setup_s": setup_s, "window_s": window_s, "attempted": n_req,
        "failed": sum(not rec["converged"] for rec in records),
        "e2e": {"cg_mdofs_per_s": 1e-6 * dofs * total / window_s},
        "memory_peak_bytes": int(peak), "records": records, "trace": trace,
        "shapes": {"dtype": cfg["dtype"],
                   "jv": {f"{cfg['degree'] + 1},{cfg['degree'] + 1 + cfg['qextra']}":
                          {"nelem": space.nelem,
                           "nodes": space.num_nodes}}},
        "checks": {"residual": [worst, r.cell.limits["residual"]["limit"]]},
    }
