"""Rank functions for `launch.run`: what the tests and chip_smoke.py run on
every rank. Each is fn(rank, world, device, ...) and returns numpy arrays
and Python values, gathered on rank 0 (the other ranks return None).

    exchange_task  g2l, l2g_add, ddot and dnorm on seeded fields of one FE
                   space; rank 0 returns every rank's blocks
    problem_task   an ElasticityProblem and its DistributedProblem, then a
                   list of jobs: "residual" (residual_apply), "step" (one
                   newton_step from given owned blocks), "solve"; each
                   job's fused-apply launches on every rank, by path and
                   by (physics, mode, P, Q)

Every rank checks, after its imports and its work, that no JAX module is
loaded: the port's ranks run without JAX.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as tdist


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


def problem_task(rank, world, device, config: dict, jobs):
    """config: Config keyword arguments (device aside). jobs: a list of
    (name, arguments): ("residual", (u_global or None (zeros), load)),
    ("step", (owned blocks (world, 3, n_owned_max) in the JAX layout or
    None (zeros), load)), ("solve", keyword arguments of
    DistributedProblem.solve). Launch counts and batch applies are set to
    0 just before each job and read just after."""
    from ..interop import owned_from_jax
    from ..ops import fused_apply as fa
    from ..problem import Config, ElasticityProblem
    from .driver import DistributedProblem

    t0 = time.perf_counter()
    prob = ElasticityProblem(Config(**config, device=device))
    t1 = time.perf_counter()
    dp = DistributedProblem(prob)
    setup = {"problem_s": t1 - t0, "distributed_s": time.perf_counter() - t1,
             "partition_s": dp.partition_seconds}
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
        elif name == "solve":
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            u, info = dp.solve(**(args or {}))
            info["wall_s"] = time.perf_counter() - t
            res = {"u": u, "info": info}
        else:
            raise ValueError(f"unknown job {name!r}")
        out[name] = res
        out[name + "_counts"] = _gather(_counts(dp))
    _no_jax()
    return out if rank == 0 else None
