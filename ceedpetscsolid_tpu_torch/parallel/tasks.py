"""Rank functions for `launch.run`: what the tests and chip_smoke.py run on
every rank. Each is fn(rank, world, device, ...) and returns numpy arrays
and Python values, gathered on rank 0 (the other ranks return None).

    exchange_task  g2l, l2g_add, ddot and dnorm on seeded fields of one FE
                   space; rank 0 returns every rank's blocks
    problem_task   an ElasticityProblem and its DistributedProblem, then a
                   list of jobs: "residual" (residual_apply), "step" (one
                   newton_step from given owned blocks), "solve" (with
                   each solve's request record), "fixed_step" (a timed
                   fixed-work Newton step, the weak-scaling point),
                   "refresh" (the AMG refreshes at seeded states beside a
                   native twin); each job's fused-apply launches on every
                   rank, by path and by (physics, mode, P, Q)

Every rank checks, after its imports and its work, that no JAX module is
loaded: the port's ranks run without JAX.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as tdist

from ..utils.timing import records, request, sync
from .launch import THREAD_ENV


def _no_jax():
    if "jax" in sys.modules:
        raise AssertionError("a rank process imported jax")


def _gather(obj):
    """Every rank's obj on rank 0 (a list by rank), None elsewhere."""
    out = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, obj)
    return out if tdist.get_rank() == 0 else None


def space_of(spec):
    """('box', faces, degree) or ('scrambled', faces, degree, seed) -> an
    FE space of the port."""
    from ..mesh.box import box_mesh
    from ..mesh.fespace import build_fespace
    from ..mesh.scrambled import scrambled_box_mesh

    kind, faces, degree, *seed = spec
    mesh = (box_mesh(faces) if kind == "box"
            else scrambled_box_mesh(faces, *seed))
    return build_fespace(mesh, degree)


def exchange_fields(num_nodes: int, seed: int):
    """The seeded global fields of exchange_task: u (g2l), g (l2g_add:
    rank r contributes (r + 1) g at every node it touches), a, b (dots)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, num_nodes)) for _ in range(4)]


def exchange_task(rank, world, device, spec, seed=0):
    from .dist import Comm, RankArrays, ddot, dnorm
    from .partition import partition_space, scatter_global_to_owned

    space = space_of(spec)
    part = partition_space(space.conn, space.num_nodes, world)
    comm = Comm(None, device)
    ra = RankArrays(part, comm)
    u, g, a, b = exchange_fields(space.num_nodes, seed)

    def owned(x):
        return torch.as_tensor(scatter_global_to_owned(part, x)[rank],
                               device=device)

    local = ra.g2l(owned(u))
    # this rank's local vector of (rank + 1) g: owned and ghost slots
    lg = ra.g2l(owned(g)) * (rank + 1)
    summed = ra.l2g_add(lg)
    dot = ddot(owned(a), owned(b), comm)
    norm = dnorm(owned(a), comm)
    out = _gather({"local": local.cpu().numpy(),
                   "l2g": summed.cpu().numpy(),
                   "dot": float(dot), "norm": float(norm)})
    _no_jax()
    return out


def _counts(dp):
    from ..ops import fused_apply as fa

    return {"by_path": dict(fa.COUNTS.by_path),
            "by_physics": dict(fa.COUNTS.by_physics),
            "launches": {"residual": fa.COUNTS.residual_launches,
                         "jacobian": fa.COUNTS.jacobian_launches},
            "batch_applies": dict(dp.batch_applies)}


def _barrier(dp):
    """Every rank here, with its device's queued work done."""
    sync(dp.device)
    if dp.comm.nccl:
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()
    sync(dp.device)


def fixed_step(dp, reps: int, profile: bool = False) -> dict:
    """The weak-scaling point (the JAX package's scripts/weak_scaling.py
    fixed_step_point): refresh_amg and pc_setup once each at u0 = 0, one
    warm newton_step, then `reps` timed newton_steps from the same u0 with
    the same AMG data and preconditioner, each bracketed by a device sync
    and a barrier; with `profile`, one more step under torch.profiler on
    rank 0. The problem's ksp_rtol 0 (taken as 1e-10 by newton_step) and
    ksp_max_it fix the CG work. Returns rank 0's dict (None elsewhere):
    "step_s" every rep's seconds, the maximum over ranks; "iters" and
    "cg_reason" of each rep; "exchange_s" the Comm.seconds() deltas over
    the timed reps per kind, and "clock" which clock they read ("device"
    under NCCL, "host" under gloo); "setup_s" every rank's refresh_amg and
    pc_setup stages; the last rep's "u1" (global), "rnorm_in", "rnorm";
    "elements", "owned" per rank, "dofs"; "profile" (rank 0's step split,
    utils.profile_solve.step_split) or None."""
    N = dp.problem.fine_space.num_nodes
    u0 = dp.to_owned(np.zeros((3, N)))
    st0 = dp.log.seconds()
    amg = dp.refresh_amg(u0, 1.0) if dp.use_mg else None
    pc = dp.pc_setup(u0, 1.0)
    setup = {k: v - st0.get(k, 0.0) for k, v in dp.log.seconds().items()}
    dp.newton_step(u0, 1.0, amg_data=amg, pc=pc)
    ex0 = dp.comm.seconds()
    times, iters, reasons = [], [], []
    _barrier(dp)
    for _ in range(reps):
        t0 = time.perf_counter()
        u1, rnorm_in, rnorm, its, _, _ = dp.newton_step(u0, 1.0,
                                                        amg_data=amg, pc=pc)
        sync(dp.device)
        times.append(time.perf_counter() - t0)
        iters.append(int(its))
        reasons.append(dp.cg_reason)
        _barrier(dp)
    ex = {k: v - ex0[k] for k, v in dp.comm.seconds().items()}
    split = None
    if profile:
        from ..utils.profile_solve import step_split

        acts = [torch.profiler.ProfilerActivity.CPU]
        if dp.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with (torch.profiler.profile(activities=acts) if dp.rank == 0
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            dp.newton_step(u0, 1.0, amg_data=amg, pc=pc)
            sync(dp.device)
            wall = time.perf_counter() - t0
        if prof is not None:
            split = step_split(prof, wall, float(np.median(times)))
        _barrier(dp)
    gids = dp.part.elem_gid
    u1 = dp.to_global(u1)
    ranks = _gather({"step_s": times, "setup_s": setup})
    if ranks is None:
        return None
    return {"step_s": [max(r["step_s"][i] for r in ranks)
                       for i in range(reps)],
            "iters": iters, "cg_reason": reasons, "exchange_s": ex,
            "clock": "device" if dp.comm.nccl else "host",
            "setup_s": [r["setup_s"] for r in ranks],
            "u1": u1, "rnorm_in": rnorm_in, "rnorm": rnorm,
            "elements": (gids >= 0).sum(axis=1).tolist(),
            "owned": dp.halo_stats()["owned_per_shard"], "dofs": 3 * N,
            "profile": split}


def amg_levels(amg) -> list:
    """The device data of an AMGPreconditioner's levels as numpy arrays
    (values, inverse diagonals, lambda_max; the coarse inverse last)."""
    out = [{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in lv.items()
            if k in ("a_val", "a_dense", "dinv", "lam")}
           for lv in amg.data["levels"]]
    return out + [amg.data["coarse_inv"].cpu().numpy()]


def refresh_pair(dp, seeds, scale: float) -> list:
    """dp.refresh_amg at seeded states u (standard normal times `scale`),
    beside a native twin on the host refreshed from the same p = 1 values
    (built at seeds[0], as dp's first refresh builds): for each seed the
    device's and the twin's levels (amg_levels), every level's float64
    CSR values ("values": the twin's, and after the first seed the device
    refresh's, which is run once more for them) and the counters of the
    refresh's request."""
    from ..solve.amg import AMGPreconditioner

    N = dp.problem.fine_space.num_nodes
    twin = AMGPreconditioner(torch.float64, "cpu")
    out = []
    for i, seed in enumerate(seeds):
        u = dp.to_owned(np.random.default_rng(seed).standard_normal(
            (3, N)) * scale)
        vals = dp.p1_values(u, 1.0)
        with request("refresh") as req:
            dp.refresh_amg(u, 1.0)
        twin.setup(dp._assembler0.from_values(vals.cpu().numpy()))
        dev = amg_levels(dp._amg)
        values = (None if i == 0 else
                  [v.cpu().numpy() for v in dp._amg.refresh(vals)])
        out.append({"device": dev, "native": amg_levels(twin),
                    "values": values,
                    "native_values": [st["vals"][:st["rowptr"][-1]].copy()
                                      for st in twin._struct],
                    "counts": dict(req.totals.counts)})
    return out


def problem_task(rank, world, device, config: dict, jobs):
    """config: Config keyword arguments (device aside). jobs: a list of
    (name, arguments): ("residual", (u_global or None (zeros), load)),
    ("step", (owned blocks (world, 3, n_owned_max) in the JAX layout or
    None (zeros), load)), ("solve", keyword arguments of
    DistributedProblem.solve, and "repeat": solves one after another,
    default 1; the last one's answer and info, every one's request record
    on rank 0), ("fixed_step", keyword arguments of fixed_step: reps,
    profile), ("refresh", (seeds, scale): refresh_pair). Launch counts and
    batch applies are set to 0 just before each job and read just
    after."""
    from ..interop import owned_from_jax
    from ..ops import fused_apply as fa
    from ..problem import Config, ElasticityProblem
    from .driver import DistributedProblem

    t0 = time.perf_counter()
    prob = ElasticityProblem(Config(**config, device=device))
    t1 = time.perf_counter()
    dp = DistributedProblem(prob)
    setup = {"problem_s": t1 - t0, "distributed_s": time.perf_counter() - t1,
             "partition_s": dp.partition_seconds,
             "threads": {"torch": torch.get_num_threads(),
                         **{k: os.environ.get(k) for k in THREAD_ENV}}}
    out = {"setup": _gather(setup), "halo": dp.halo_stats(),
           "use_mg": dp.use_mg, "n_elem_int": _gather(
               [lv.ra.n_elem_int for lv in dp.levels])}
    N = prob.fine_space.num_nodes
    for name, args in jobs:
        fa.COUNTS.reset()
        dp.batch_applies = dict.fromkeys(dp.batch_applies, 0)
        if name == "residual":
            u, load = args
            uo = dp.to_owned(np.zeros((3, N)) if u is None else u)
            res = dp.to_global(dp.residual_apply(uo, load))
        elif name == "step":
            blocks, load = args
            u0 = (dp.to_owned(np.zeros((3, N))) if blocks is None else
                  owned_from_jax(blocks, rank, prob.dtype, device=device))
            amg = dp.refresh_amg(u0, load) if dp.use_mg else None
            u1, rin, rn, its, step, unorm = dp.newton_step(u0, load,
                                                           amg_data=amg)
            res = {"u1": dp.to_global(u1), "rnorm_in": rin, "rnorm": rn,
                   "iters": its, "step_norm": step, "unorm": unorm}
        elif name == "fixed_step":
            res = fixed_step(dp, **args)
        elif name == "solve":
            kw = dict(args or {})
            recs = []
            for _ in range(kw.pop("repeat", 1)):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t = time.perf_counter()
                u, info = dp.solve(**kw)
                info["wall_s"] = time.perf_counter() - t
                recs.append(records()[-1])
            res = {"u": u, "info": info, "records": recs}
        elif name == "refresh":
            res = refresh_pair(dp, *args)
        else:
            raise ValueError(f"unknown job {name!r}")
        out[name] = res
        out[name + "_counts"] = _gather(_counts(dp))
    _no_jax()
    return out if rank == 0 else None
