"""Distributed p-multigrid pieces of the Newton step.
Port of ceedpetscsolid_tpu/parallel/mg.py.

Per multigrid level: the same element order as the fine level (coarse
levels are partitioned with the fine partition's `elem_gid`, so
element-indexed qdata and the gradu stash line up across levels), the
level's own node ownership and halo maps (`dist.RankArrays`), its BC mask,
its basis at the FINE quadrature (P_l -> Q_fine: the JAX package's
distributed driver integrates every level at the fine Gauss rule), the
Gauss-Lobatto interpolation from the coarser level and the owned inverse
multiplicity that scales the prolongation (reference src/matops.c:115-203).

The AMG coarse solve runs on the small assembled p = 1 system REPLICATED
on every rank: the coarse residual is all-gathered into the global node
order, every rank runs the same V-cycle, and each keeps its owned slice,
the analog of PETSc's (also effectively global) coarse GAMG solve.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.basis import Basis3D
from ..solve.cg import estimate_extreme_eigs
from .dist import Comm, RankArrays, ddot
from .partition import SpacePartition, partition_space, scatter_global_to_owned


@dataclass
class DistLevel:
    """One level's data on this rank (tensors on the rank's device)."""

    part: SpacePartition
    ra: RankArrays
    mask: torch.Tensor           # (3, n_owned_max) bool, constrained
    basis: Basis3D               # P_level -> Q_fine
    pbasis: Basis3D | None       # P_level -> 1 + qextra (composite models)
    c2f: Basis3D | None          # GLL interp from the coarser level
    inv_mult: torch.Tensor | None  # (3, n_owned_max) 1 / multiplicity
    owned_gid: torch.Tensor      # (n_owned_max,) int64 global ids, 0 pad
    num_nodes: int
    rep_pos: torch.Tensor        # valid slots of the all-gathered blocks
    rep_gid: torch.Tensor        # ... and their global ids


def owned_slice(part: SpacePartition, rank: int, arr: np.ndarray,
                dtype, device) -> torch.Tensor:
    """(c, num_nodes) global array -> this rank's (c, n_owned_max) block,
    zero padding."""
    block = scatter_global_to_owned(part, np.asarray(arr))[rank]
    return torch.as_tensor(np.ascontiguousarray(block), dtype=dtype,
                           device=device)


def build_dist_levels(problem, part_fine: SpacePartition, comm: Comm,
                      levels=None) -> tuple[list[DistLevel], dict]:
    """DistLevel data for the given levels of an ElasticityProblem (all of
    them by default), coarse -> fine, and the seconds partition_space
    took on each coarser level."""
    spaces = problem.spaces
    nlev = len(spaces)
    levels = range(nlev) if levels is None else levels
    dev, dt, r = comm.device, problem.dtype, comm.rank
    out, seconds = [], {}
    prev_degree = None
    for l in levels:
        space = spaces[l]
        if l == nlev - 1:
            part = part_fine
        else:
            t0 = time.perf_counter()
            part = partition_space(space.conn, space.num_nodes, comm.world,
                                   elem_gid=part_fine.elem_gid)
            seconds[space.degree] = time.perf_counter() - t0
        mask = owned_slice(part, r, problem._level_mask(space).cpu().numpy(),
                           torch.bool, dev)
        c2f = inv_mult = None
        if prev_degree is not None:
            c2f = Basis3D.create(prev_degree + 1, space.degree + 1,
                                 "gauss_lobatto", dt, device=dev)
            mult = np.bincount(space.conn.reshape(-1),
                               minlength=space.num_nodes).astype(np.float64)
            mult[mult == 0] = 1.0
            inv_mult = owned_slice(
                part, r, np.broadcast_to(1.0 / mult, (3, space.num_nodes)),
                dt, dev)
        gid = np.where(part.owned_valid, part.owned_global_ids, 0)
        valid = part.owned_valid.reshape(-1)
        out.append(DistLevel(
            part=part, ra=RankArrays(part, comm), mask=mask,
            basis=problem.factory.levels[l].basis,
            pbasis=(problem.pfactory.levels[l].basis if problem.composite
                    else None),
            c2f=c2f, inv_mult=inv_mult,
            owned_gid=torch.as_tensor(gid[r], device=dev),
            num_nodes=space.num_nodes,
            rep_pos=torch.as_tensor(np.nonzero(valid)[0], device=dev),
            rep_gid=torch.as_tensor(gid.reshape(-1)[valid], device=dev)))
        prev_degree = space.degree
    return out, seconds


def prolong(uc: torch.Tensor, lvl_c: DistLevel, lvl_f: DistLevel):
    """Coarse owned -> fine owned (matops.c:115-157, distributed)."""
    ue = lvl_c.ra.gather_elements(lvl_c.ra.g2l(uc))
    acc = lvl_f.ra.scatter_elements(lvl_f.c2f.apply_interp(ue))
    return lvl_f.ra.l2g_add(acc) * lvl_f.inv_mult


def restrict(uf: torch.Tensor, lvl_c: DistLevel, lvl_f: DistLevel):
    """Fine owned -> coarse owned (matops.c:160-203, distributed)."""
    fe = lvl_f.ra.gather_elements(lvl_f.ra.g2l(uf * lvl_f.inv_mult))
    acc = lvl_c.ra.scatter_elements(lvl_f.c2f.apply_interp_T(fe))
    return lvl_c.ra.l2g_add(acc)


def owned_to_replicated_global(owned: torch.Tensor, lvl: DistLevel,
                               comm: Comm) -> torch.Tensor:
    """(3, n_owned_max) -> the (3, num_nodes) global vector on every rank:
    one all-gather of the padded blocks; every node is owned once, so each
    is written once (the global ids of the gathered slots are known from
    the partition on every rank)."""
    blocks = comm.all_gather(owned)                   # (world, 3, n_owned)
    flat = blocks.transpose(0, 1).reshape(owned.shape[0], -1)
    g = owned.new_zeros((owned.shape[0], lvl.num_nodes))
    g[:, lvl.rep_gid] = flat[:, lvl.rep_pos]
    return g


def replicated_global_to_owned(g: torch.Tensor, lvl: DistLevel):
    """Replicated (3, num_nodes) -> this rank's (3, n_owned_max) slice."""
    return g[:, lvl.owned_gid]


def probe_vector(shape, dtype, device) -> torch.Tensor:
    """The eigenvalue estimate's 'noisy' right-hand side: the integer hash
    of the shard-local flat slot index, (i * 2654435761 mod 2^32) mod 65536
    over 65536, minus 1/2; bit for bit the JAX package's (its uint32
    product wraps mod 2^32, which leaves the residue mod 65536 as it is)."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    r = ((idx * 2654435761) % 65536).to(dtype) / 65536.0 - 0.5
    return r.reshape(shape)


def estimate_eigs_dist(A, dinv, valid, comm: Comm, iters: int = 10):
    """Distributed CG-Lanczos estimate of the Chebyshev bounds
    (0.1, 1.1) x lam_max of D^-1 A (elasticity.c:540): the serial
    estimate_extreme_eigs from the JAX package's probe vector, `valid`
    masking BC and padding slots out of it, with the all-reduced dot. A
    Krylov breakdown keeps the Lanczos steps before it, as the serial
    estimate does, where the JAX package returns NaN bounds."""
    r0 = torch.where(valid, probe_vector(valid.shape, dinv.dtype,
                                         dinv.device), 0.0)
    return estimate_extreme_eigs(A, dinv, valid.shape, dinv.dtype,
                                 iters=iters, r0=r0,
                                 dot=lambda a, b: ddot(a, b, comm))
