"""Fused element apply: gather -> B -> pointwise physics -> B^T, per element.

Counterpart of ceedpetscsolid_tpu/ops/pallas_apply.py (the TPU kernel
`_apply_kernel` built by `make_fused_apply` for every model's
`residual_planes` / `jacobian_planes`). Two implementations of one
function:

  * `residual_plain` / `jacobian_plain`: plain torch (conn gather, Kronecker
    einsum, Mat3 physics, adjoint einsum). The CPU path and the reference
    the kernel is tested against.
  * the CUDA kernel in csrc/fused_apply.cu, launched by `residual` /
    `jacobian` for tensors on a CUDA device.

The pointwise physics is one of `PHYSICS` (by name): hyperFS, linElas,
hyperSS, and hyperFSIncomp's two parts, the deviatoric mu part at full
quadrature and the pressure part at Q = 1 + qextra. The CUDA kernel
takes it as a template parameter (ids shared with csrc/fused_apply.cu).

`residual` and `jacobian` choose by the device of their input: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel, and raises if
the kernel cannot be built or launched. There is no fallback from CUDA to
the plain version, nor from one body of the kernel to another. A
(physics, P, Q) with a template instance (`Pointwise.instances`) feeds its
per-point streams into shared memory by TMA bulk copies or by cp.async, as
`copy_path` says (the kernel decides by the same rule); every other pair
runs on the generic tile, whose P and Q are run-time arguments
(`is_generic`): a register body up to P, Q = 8, the cluster body above
(an element in the shared memory of a thread-block cluster of up to
CLUSTER_MAX CTAs), and the global-memory body where no such cluster holds
an element, at any (P, Q) within `GENERIC_MAX_PQ`. The library chooses the
body and sizes the tile (the cluster) from the element count and the
card's own limits; the wrapper allocates the gmem body's workspace at the
size the library's plan gives, and `generic_plan` mirrors that plan at
the H100's limits for the tests and `COUNTS`. `COUNTS.by_path` counts each
path: "bulk", "async", "generic", "generic_cluster", "generic_gmem".
`plan` reports the launch the kernel makes (tile, threads, shared memory,
path, the generic tile's body and copy path, the workspace, the cluster
size and count).

`min_bytes` and `min_flops` count what one apply must move and compute,
from shapes alone; `bound_ms` turns them into the least time the card
could take (the H100's published rates).

Outputs are E-vectors (3, nelem, P3); the owner-sum to the L-vector is
ops/restriction.Restriction.scatter_add. The stash is one contiguous
(9, nelem, Q3) tensor: plane 3c+k holds gradu[c, k]. A physics without a
stash (linElas) returns None for it and takes None.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..models import hyper_fs, hyper_fs_incomp, hyper_ss, lin_elas
from ..models.base import Mat3, Physics
from .basis import Basis3D

# (P, Q) template instances compiled into the kernel library for the
# full-quadrature physics: every 2 <= P <= Q <= 6, i.e. degrees 1-5 at their
# own Gauss rule and every coarser p-multigrid level at a finer level's rule;
# the pressure term has (P, 1) for 2 <= P <= 6. The one place the limit is
# set: csrc/build.py passes it to nvcc as -DCPS_FUSED_MAX_Q. Every other
# pair runs on the generic tile.
MAX_Q = 6
INSTANTIATED_PQ = frozenset((P, Q) for Q in range(2, MAX_Q + 1)
                            for P in range(2, Q + 1))
REDUCED_PQ = frozenset((P, 1) for P in range(2, MAX_Q + 1))
_DTYPES = {torch.float32: 0, torch.float64: 1}

# The generic tile (csrc/fused_apply.cu generic_launch). Its register
# bodies (generic_reg_kernel) take P, Q <= GENERIC_REG_CAP: a warp a tile
# for Q <= GENERIC_WARP_Q (GENERIC_CAPS: "warp3x2", "warp6x2", "warp8x3",
# the first whose caps hold (P, Q)), a block of up to GENERIC_THREADS
# threads a tile above ("block8x8"); a tile grows past one element only
# once the card has GENERIC_WARPS_PER_SM warp tiles (a block tile) an SM;
# a tile of more than one element stays within GENERIC_BUDGET bytes of
# shared memory. Above the cap the cluster body (generic_cluster_kernel,
# "cluster") runs one element a cluster of k CTAs of GENERIC_THREADS
# threads (cluster_plan, cluster_size), where a CTA's share fits what a
# block of the H100 may opt in to (H100_SMEM_PER_BLOCK,
# cudaDevAttrMaxSharedMemoryPerBlockOptin) at k <= CLUSTER_MAX; else the
# global-memory body (generic_gmem_kernel, "gmem") runs it, one element a
# block at a time, its buffers in a global workspace, on a persistent grid
# of GMEM_BLOCKS_PER_SM blocks an SM (fewer with fewer elements).
GENERIC_THREADS = 256
GENERIC_BUDGET = 64 * 1024
GENERIC_MAX_PQ = 64
GENERIC_REG_CAP = 8
GENERIC_WARP_Q = 3
GENERIC_WARPS_PER_SM = 4
H100_SMEM_PER_BLOCK = 232_448
H100_SMS = 132
GMEM_BLOCKS_PER_SM = 2
BAR_BYTES = 16          # the tile's mbarrier, padded to 16 bytes
# the cluster body: at most CLUSTER_MAX CTAs a cluster (the portable limit);
# the plan doubles the fewest that fit while a CTA takes more than
# CLUSTER_PAIR_SMEM (two CTAs, which the registers allow, would not share
# an SM: H100_SM_SMEM less a block's reserve each) or the grid has fewer
# CTAs than the card has SMs
CLUSTER_MAX = 8
H100_SM_SMEM = 233_472
CLUSTER_PAIR_SMEM = (H100_SM_SMEM - 2 * 1024) // 2
# cps_fused_plan's body codes of the generic tile (0, a shared-memory body,
# is retired)
GENERIC_BODIES = {1: "warp3x2", 2: "warp6x2", 3: "warp8x3", 4: "block8x8",
                  5: "gmem", 6: "cluster"}
# the register bodies' caps (PC >= P, QC >= Q) of their row arrays
GENERIC_CAPS = {1: (3, 2), 2: (6, 2), 3: (8, 3), 4: (8, 8)}


@dataclass(frozen=True)
class Pointwise:
    """One pointwise physics of the fused apply.

    kernel_id: the template argument of csrc/fused_apply.cu; params: the
    kernel's two scalars (a, b) from the material; stash: whether the
    residual writes (and the Jacobian reads) the gradu stash; instances:
    the (P, Q) pairs compiled as template instances for it (the generic
    tile runs the others)."""

    name: str
    kernel_id: int
    residual_planes: Callable
    jacobian_planes: Callable
    params: Callable[[Physics], tuple[float, float]]
    # flops a quadrature point, (residual, J.v): the pointwise physics and
    # its wrapper (du X, P X^T, the wdetJ scaling: 99), counted by hand in
    # csrc/fused_apply.cu, one per add, multiply or divide
    flops: tuple[int, int]
    stash: bool = True
    instances: frozenset = INSTANTIATED_PQ


def _lam_mu(phys: Physics) -> tuple[float, float]:
    return phys.lam, phys.mu


PHYSICS = {pw.name: pw for pw in (
    Pointwise("hyperFS", 0, hyper_fs.residual_planes,
              hyper_fs.jacobian_planes, _lam_mu, (362, 616)),
    Pointwise("linElas", 1, lin_elas.residual_planes,
              lin_elas.jacobian_planes, lin_elas.voigt_params, (140, 140),
              stash=False),
    Pointwise("hyperSS", 2, hyper_ss.residual_planes,
              hyper_ss.jacobian_planes, lambda p: (p.lam, p.two_mu),
              (147, 138)),
    Pointwise("hyperFSIncomp", 3, hyper_fs_incomp.residual_planes,
              hyper_fs_incomp.jacobian_planes, _lam_mu, (325, 550)),
    Pointwise(hyper_fs_incomp.pressure_name, 4,
              hyper_fs_incomp.pressure_residual_planes,
              hyper_fs_incomp.pressure_jacobian_planes, _lam_mu, (299, 553),
              instances=REDUCED_PQ),
)}


def pointwise(physics: str | Pointwise) -> Pointwise:
    """The Pointwise of a physics name (a Pointwise passes through)."""
    if isinstance(physics, Pointwise):
        return physics
    try:
        return PHYSICS[physics]
    except KeyError:
        raise ValueError(f"fused apply has no physics {physics!r}; choose "
                         f"from {sorted(PHYSICS)}") from None


class LaunchCounts:
    """Kernel launches per mode, per (mode, P, Q), per (physics, mode, P, Q),
    per (physics, mode, P, Q, elements), per (mode, path) and per
    (physics, mode, P, Q, path), counted where the wrapper launches. Launch
    bookkeeping only: nothing reads it to decide anything."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.residual_launches = 0
        self.jacobian_launches = 0
        self.by_pq = {}             # ("residual" | "jacobian", P, Q) -> n
        self.by_physics = {}        # (physics, mode, P, Q) -> n
        self.by_shape = {}          # (physics, mode, P, Q, nelem) -> n
        self.by_path = {}           # (mode, launch_path) -> n
        self.by_pq_path = {}        # (physics, mode, P, Q, launch_path) -> n

    def add(self, mode: str, basis: Basis3D, physics: str = "hyperFS",
            path: str = "bulk", nelem: int = 0):
        if mode == "residual":
            self.residual_launches += 1
        else:
            self.jacobian_launches += 1
        key = (mode, basis.P, basis.Q)
        self.by_pq[key] = self.by_pq.get(key, 0) + 1
        key = (physics, *key)
        self.by_physics[key] = self.by_physics.get(key, 0) + 1
        key = (*key, nelem)
        self.by_shape[key] = self.by_shape.get(key, 0) + 1
        key = (mode, path)
        self.by_path[key] = self.by_path.get(key, 0) + 1
        key = (physics, mode, basis.P, basis.Q, path)
        self.by_pq_path[key] = self.by_pq_path.get(key, 0) + 1


COUNTS = LaunchCounts()


# ---------------------------------------------------------------------------
# the bound from shapes
# ---------------------------------------------------------------------------
# NVIDIA H100 SXM, published: HBM3 bytes/s; f32 and f64 FLOP/s outside the
# tensor cores
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def min_bytes(physics, mode: str, P: int, Q: int, nelem: int,
              num_nodes: int, dtype) -> int:
    """Bytes one apply must move, each input read once and each output
    written once: qdata (10 words a point), the stash (9 a point, read by
    J.v, written by the residual; none for linElas), u (3 words a node),
    conn (int64, P^3 an element) and ve (3 P^3 words an element)."""
    pw = pointwise(physics)
    if mode not in ("residual", "jacobian"):
        raise ValueError(f"mode is residual or jacobian, not {mode!r}")
    w = torch.empty((), dtype=dtype).element_size()
    points = nelem * Q ** 3
    nodal = nelem * P ** 3
    stash = 9 * points if pw.stash else 0
    return (w * (10 * points + stash + 3 * num_nodes + 3 * nodal)
            + 8 * nodal)


def min_flops(physics, mode: str, P: int, Q: int, nelem: int) -> int:
    """Flops of one apply: the sum-factorized contractions (an FMA counts
    2) and the pointwise physics (Pointwise.flops) at every point."""
    pw = pointwise(physics)
    forward = 3 * P * P * Q * 2 * P + 3 * P * Q * Q * 3 * P + Q ** 3 * 9 * P
    adjoint = Q ** 3 * 9 * P + 3 * P * P * Q * 3 * Q + 3 * P ** 3 * 2 * Q
    point = pw.flops[0 if mode == "residual" else 1]
    return nelem * (2 * (forward + adjoint) + Q ** 3 * point)


def bound_ms(physics, mode: str, P: int, Q: int, nelem: int,
             num_nodes: int, dtype) -> tuple[float, str]:
    """(the least ms the H100 could take for one apply, "bytes" or
    "operations": which of the two bounds it)."""
    t_bytes = min_bytes(physics, mode, P, Q, nelem, num_nodes,
                        dtype) / H100_BYTES_PER_S
    t_ops = min_flops(physics, mode, P, Q, nelem) / H100_FLOPS[dtype]
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else \
        (1e3 * t_ops, "operations")


def is_generic(physics, P: int, Q: int) -> bool:
    """Whether (physics, P, Q) runs on the generic tile: every pair without
    a template instance (csrc/fused_apply.cu generic_pq is the same rule)."""
    return (P, Q) not in pointwise(physics).instances


class GenericPlan(NamedTuple):
    """The generic tile's launch (csrc/fused_apply.cu generic_launch)."""

    path: str       # "generic" (a register body) | "generic_gmem" |
                    # "generic_cluster"
    body: str       # GENERIC_BODIES
    elems: int      # elements a tile (one tile a block)
    threads: int    # threads a block
    smem: int       # dynamic shared memory a block (a CTA), bytes
    tiles: int      # blocks
    work: int = 0   # the gmem body's global workspace, bytes
    cluster: int = 0    # the cluster body's CTAs a cluster
    clusters: int = 0   # the cluster body's clusters (one an element)


def _buffer_words(P: int, Q: int) -> int:
    """Buffers A and B of one element of the gmem body, in words:
    max(3 P^3, 9 P Q^2) + max(6 P^2 Q, 9 Q^3)."""
    return max(3 * P ** 3, 9 * P * Q * Q) + max(6 * P * P * Q, 9 * Q ** 3)


class ClusterPlan(NamedTuple):
    """One CTA's share of an element in the cluster body
    (csrc/fused_apply.cu cluster_plan)."""

    nzc: int        # pz-slabs a CTA: ceil(P / k)
    ncc: int        # (qy, qx) columns a CTA: ceil(Q^2 / k)
    a_words: int    # region A: max(9 P ncc, 9 nzc Q^2)
    b_words: int    # region B: max(3 nzc P^2 + 6 nzc P Q, 9 Q ncc)
    smem: int       # bytes: B, D, B^T, D^T (4 Q P words), A and B


def cluster_plan(P: int, Q: int, w: int, k: int) -> ClusterPlan:
    """The share of one of k CTAs at (P, Q) in words of `w` bytes."""
    nzc, ncc = -(-P // k), -(-Q * Q // k)
    a = max(9 * P * ncc, 9 * nzc * Q * Q)
    b = max(3 * nzc * P * P + 6 * nzc * P * Q, 9 * Q * ncc)
    return ClusterPlan(nzc, ncc, a, b, w * (4 * Q * P + a + b))


def cluster_fewest(P: int, Q: int, w: int,
                   optin: int = H100_SMEM_PER_BLOCK) -> int:
    """The fewest CTAs, at most CLUSTER_MAX, whose share fits `optin`
    bytes; 0 when none does (the gmem body's shapes)."""
    return next((k for k in range(1, CLUSTER_MAX + 1)
                 if cluster_plan(P, Q, w, k).smem <= optin), 0)


def cluster_size(P: int, Q: int, w: int, nelem: int, sms: int = H100_SMS,
                 optin: int = H100_SMEM_PER_BLOCK) -> int:
    """The plan's CTAs a cluster: the fewest that fit, doubled (up to
    CLUSTER_MAX) while a CTA's share exceeds CLUSTER_PAIR_SMEM or
    nelem k < sms."""
    k = cluster_fewest(P, Q, w, optin)
    while k and 2 * k <= CLUSTER_MAX and (
            cluster_plan(P, Q, w, k).smem > CLUSTER_PAIR_SMEM
            or nelem * k < sms):
        k *= 2
    return k


def generic_body(P: int, Q: int, dtype) -> int:
    """The generic tile's body at (P, Q) in `dtype` (GENERIC_BODIES):
    above GENERIC_REG_CAP 6 cluster where a cluster of at most CLUSTER_MAX
    CTAs holds an element, else 5 gmem; 4 block8x8 above GENERIC_WARP_Q,
    else the first warp body whose caps hold (P, Q). A mirror of the
    library's generic_body at the H100's opt-in limit, for the tests and
    COUNTS; the launch never reads it."""
    if P > GENERIC_REG_CAP or Q > GENERIC_REG_CAP:
        w = torch.empty((), dtype=dtype).element_size()
        return 6 if cluster_fewest(P, Q, w) else 5
    if Q > GENERIC_WARP_Q:
        return 4
    return next(b for b in (1, 2, 3)
                if P <= GENERIC_CAPS[b][0] and Q <= GENERIC_CAPS[b][1])


def generic_plan(P: int, Q: int, dtype, nelem: int, sms: int = H100_SMS,
                 planes: int = 19, cluster: int = 0) -> GenericPlan:
    """The generic tile's launch for `nelem` elements on a card of `sms`
    SMs; `planes`: the per-point streams a register body stages (19 in a
    J.v that reads a stash, else 10); `cluster` > 0: the cluster body's
    size instead of cluster_size's. csrc/fused_apply.cu generic_launch,
    mirrored.

    The cluster body: one element a cluster of k CTAs of GENERIC_THREADS
    threads, each with cluster_plan's shared memory, nelem clusters.

    Register bodies (P, Q <= 8), in words: B, D as Q rows of PCV and B^T,
    D^T as P rows of QCV (the body's caps GENERIC_CAPS rounded up to 16
    bytes); per element buffer A max(3 P^2 PP, 9 Q^2 PP, 9 P Q QQ) and
    buffer B max(6 P Q PP, 9 Q^3, 6 P^2 QQ), PP = P | 1, QQ = Q | 1; per
    staged plane E Q^3 rounded up to 16 bytes, + 16 bytes. E is at most
    32 // Q^3 (a warp tile) or 256 // Q^3 (a block tile, at least 1), at
    most nelem // (4 sms) (warp) or nelem // sms (block), at least 1, and
    shrinks while above GENERIC_BUDGET. A block tile's threads: its E Q^3
    points (or 3 E max(P, Q)^2 lines, if more) over the fewest passes of
    at most 256, spread evenly, rounded up to a warp. The gmem body: B and
    D (2 Q P words) in shared memory, one element a block at a time on
    min(nelem, GMEM_BLOCKS_PER_SM sms) blocks, each with its slice of the
    workspace: one element's buffers A and B, max(3 P^3, 9 P Q^2) +
    max(6 P^2 Q, 9 Q^3) words."""
    w = torch.empty((), dtype=dtype).element_size()
    body = generic_body(P, Q, dtype)
    Q3 = Q ** 3
    if body == 6:
        k = cluster or cluster_size(P, Q, w, nelem, sms)
        return GenericPlan("generic_cluster", GENERIC_BODIES[6], 1,
                           GENERIC_THREADS, cluster_plan(P, Q, w, k).smem,
                           nelem * k, 0, k, nelem)
    if body == 5:
        blocks = min(nelem, GMEM_BLOCKS_PER_SM * sms)
        return GenericPlan("generic_gmem", GENERIC_BODIES[5], 1,
                           GENERIC_THREADS, w * 2 * Q * P, blocks,
                           w * blocks * _buffer_words(P, Q))
    PC, QC = GENERIC_CAPS[body]
    V, PP, QQ = 16 // w, P | 1, Q | 1
    a = max(3 * P * P * PP, 9 * Q * Q * PP, 9 * P * Q * QQ)
    b = max(6 * P * Q * PP, 9 * Q3, 6 * P * P * QQ)
    bd = 2 * Q * (-(-PC // V) * V) + 2 * P * (-(-QC // V) * V)
    warp = body != 4
    most = max(1, (32 if warp else GENERIC_THREADS) // Q3)
    E = min(most, max(1, nelem // ((GENERIC_WARPS_PER_SM if warp else 1)
                                   * sms)))

    def smem(e):
        stride = -(-e * Q3 // V) * V + V
        return BAR_BYTES + w * (bd + planes * stride + e * (a + b))

    while E > 1 and smem(E) > GENERIC_BUDGET:
        E -= 1
    n = max(E * Q3, 3 * E * max(P, Q) ** 2)
    passes = -(-n // GENERIC_THREADS)
    threads = 32 if warp else -(-(-(-n // passes)) // 32) * 32
    return GenericPlan("generic", GENERIC_BODIES[body], E, threads, smem(E),
                       -(-nelem // E))


def require_fits(physics, P: int, Q: int):
    """Raise NotImplementedError when (physics, P, Q) runs on the generic
    tile and lies outside its range (2 <= P <= GENERIC_MAX_PQ,
    1 <= Q <= GENERIC_MAX_PQ): the CUDA fused apply runs everything else,
    in either dtype."""
    if not is_generic(physics, P, Q):
        return
    if not (2 <= P <= GENERIC_MAX_PQ and 1 <= Q <= GENERIC_MAX_PQ):
        raise NotImplementedError(
            f"fused CUDA apply takes 2 <= P <= {GENERIC_MAX_PQ} and "
            f"1 <= Q <= {GENERIC_MAX_PQ}, not P={P}, Q={Q}")


def copy_path(qdata: torch.Tensor, stash_in: torch.Tensor | None) -> str:
    """How a launch feeds its per-point streams (qdata; in J.v the stash)
    into shared memory: "bulk" (TMA bulk copies) when each starts 16-byte
    aligned and a plane (nelem Q^3 words) is a multiple of 16 bytes, so
    that every tile's slice is too; else "async" (cp.async, word by word).
    csrc/fused_apply.cu's bulk_path is the same rule."""
    plane = qdata.shape[1] * qdata.shape[2] * qdata.element_size()
    ptrs = [qdata.data_ptr()]
    if stash_in is not None:
        ptrs.append(stash_in.data_ptr())
    aligned = plane % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    return "bulk" if aligned else "async"


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------
def residual_plain(u, conn, qdata, basis: Basis3D, phys: Physics,
                   physics: str | Pointwise = "hyperFS"):
    """(u (3, N), conn (nelem, P3), qdata (10, nelem, Q3)) ->
    (ve (3, nelem, P3), stash (9, nelem, Q3) or None)."""
    pw = pointwise(physics)
    du = basis.apply_grad(u[:, conn])                     # (3, 3, e, Q3)
    dv, gradu = pw.residual_planes(Mat3.from_array(du), qdata, phys)
    stash = None if gradu is None else torch.stack(gradu.m)
    return basis.apply_grad_T(dv.to_array()), stash


def jacobian_plain(v, conn, qdata, stash, basis: Basis3D, phys: Physics,
                   physics: str | Pointwise = "hyperFS"):
    """(v (3, N), ..., stash (9, nelem, Q3) or None) -> J.v E-vector
    (3, nelem, P3)."""
    pw = pointwise(physics)
    ddu = basis.apply_grad(v[:, conn])
    st = None if stash is None else Mat3(stash.unbind(0))
    dv = pw.jacobian_planes(Mat3.from_array(ddu), qdata, st, phys)
    return basis.apply_grad_T(dv.to_array())


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library():
    """Build (first use) and load the kernel library."""
    from ..csrc.build import build

    path, _ = build()
    lib = ctypes.CDLL(str(path))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.cps_fused_apply.argtypes = [
        c_int, c_int, c_int, c_int, c_int,     # physics, jacobian, P, Q, f64
        c_ptr, ctypes.c_longlong, c_ptr, c_int,   # u, N, conn, nelem
        c_ptr, c_ptr, c_ptr,                   # qdata, B, D
        c_ptr, c_ptr,                          # stash, ve
        ctypes.c_double, ctypes.c_double,      # the physics' (a, b)
        c_ptr,                                 # stream
        c_ptr, ctypes.c_longlong,              # gmem workspace, its bytes
        c_int,                                 # cluster size (0: the plan's)
    ]
    lib.cps_fused_apply.restype = c_int
    lib.cps_fused_plan.argtypes = [
        c_int, c_int, c_int, c_int, c_int,     # physics, jacobian, P, Q, f64
        c_int, c_ptr, c_ptr,                   # nelem, qdata, stash
        ctypes.POINTER(ctypes.c_longlong),     # out[PLAN_WORDS]
    ]
    lib.cps_fused_plan.restype = c_int
    return lib


# cps_fused_plan's out[]: elems, threads, smem, tiles, path, min_blocks,
# the generic tile's copy path and body, the gmem body's workspace bytes,
# the cluster body's CTAs a cluster and clusters. Path 2, the shared-memory
# body of the libraries before the cluster body, is named for
# utils/compare_fused, which reads their plans.
PLAN_WORDS = 11
PATHS = ("async", "bulk", "generic_smem", "generic", "generic_gmem",
         "generic_cluster")


@dataclass(frozen=True)
class Plan:
    """The launch the kernel makes for one apply (csrc cps_fused_plan)."""

    elems: int          # elements a tile (one tile a block)
    threads: int        # threads a block
    smem: int           # dynamic shared memory a block, bytes
    tiles: int          # tiles (blocks, or tiles walked by the blocks)
    path: str           # "bulk" | "async" | "generic" | "generic_gmem" |
                        # "generic_cluster"
    min_blocks: int     # resident blocks an SM that __launch_bounds__ asks
    copy: str | None = None   # the generic tile's streams: "bulk" | "async"
    body: str = ""      # the generic tile's body (GENERIC_BODIES)
    work: int = 0       # the gmem body's global workspace, bytes
    cluster: int = 0    # the cluster body's CTAs a cluster (smem: a CTA's)
    clusters: int = 0   # the cluster body's clusters


def plan(jacobian: bool, qdata, basis: Basis3D, stash_in=None,
         physics: str | Pointwise = "hyperFS", lib=None) -> Plan:
    """The kernel's own launch plan for these inputs (needs the built
    library; no launch)."""
    pw = pointwise(physics)
    lib = lib or _library()
    out = (ctypes.c_longlong * PLAN_WORDS)(*([0] * PLAN_WORDS))
    r = lib.cps_fused_plan(
        pw.kernel_id, int(jacobian), basis.P, basis.Q,
        _DTYPES[qdata.dtype], qdata.shape[1], qdata.data_ptr(),
        None if stash_in is None else stash_in.data_ptr(), out)
    if r == -1:
        raise NotImplementedError(f"fused apply has no kernel for P="
                                  f"{basis.P}, Q={basis.Q} of {pw.name}")
    if r != 0:
        raise RuntimeError(f"fused_apply plan: cuda error {r}")
    e, t, sm, tiles, path, mb, copy, body, work, k, clusters = out
    return Plan(e, t, sm, tiles, PATHS[path], mb,
                None if copy < 0 else ("async", "bulk")[copy],
                GENERIC_BODIES.get(body, ""), work, k, clusters)


def _check(u, conn, qdata, basis: Basis3D, stash,
           physics: str | Pointwise = "hyperFS"):
    """Validate what the kernel takes; raise on anything else. `stash` is
    None for a physics without one."""
    pw = pointwise(physics)
    dev, dt = u.device, u.dtype
    P, Q = basis.P, basis.Q
    if dt not in _DTYPES:
        raise TypeError(f"fused CUDA apply takes float32/float64, got {dt}")
    require_fits(pw, P, Q)
    nelem = conn.shape[0]
    expect = {
        "u": (u, (3, u.shape[1]), dt),
        "conn": (conn, (nelem, P ** 3), torch.int64),
        "qdata": (qdata, (10, nelem, Q ** 3), dt),
        "basis.B": (basis.B, (Q, P), dt),
        "basis.D": (basis.D, (Q, P), dt),
    }
    if pw.stash:
        expect["stash"] = (stash, (9, nelem, Q ** 3), dt)
    elif stash is not None:
        raise ValueError(f"{pw.name} has no stash; got one")
    for name, (t, shape, tdt) in expect.items():
        if t is None:
            raise ValueError(f"{name} is missing")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != tdt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {tdt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nelem >= 2 ** 31:
        raise ValueError(f"nelem={nelem} exceeds the kernel's grid limit")


@functools.lru_cache(maxsize=None)
def _work_bytes(lib, kernel_id: int, jacobian: bool, P: int, Q: int,
                is_double: int, nelem: int, index: int) -> int:
    """The gmem body's workspace bytes of this launch on device `index`, as
    `lib`'s own plan gives them (cps_fused_plan's out[8]; 0 for every
    other body): the library alone decides the body and the size."""
    out = (ctypes.c_longlong * PLAN_WORDS)(*([0] * PLAN_WORDS))
    r = lib.cps_fused_plan(kernel_id, int(jacobian), P, Q, is_double, nelem,
                           None, None, out)
    if r != 0:
        raise RuntimeError(f"fused_apply plan: cuda error {r}")
    return out[8]


def _launch(jacobian: bool, u, conn, qdata, basis, stash, ve, phys,
            pw: Pointwise, lib=None, cluster: int = 0):
    """One launch of `lib`'s cps_fused_apply (the package's own library
    unless another is given), with the gmem body's workspace, from torch's
    caching allocator on u's device, where it runs, and `cluster` (0: the
    plan's cluster size); raises on a CUDA error."""
    lib = lib or _library()
    a, b = pw.params(phys)
    with torch.cuda.device(u.device):
        work = None
        if is_generic(pw, basis.P, basis.Q):
            nbytes = _work_bytes(lib, pw.kernel_id, jacobian, basis.P,
                                 basis.Q, _DTYPES[u.dtype], conn.shape[0],
                                 torch.cuda.current_device())
            if nbytes:
                work = torch.empty(nbytes, dtype=torch.uint8,
                                   device=u.device)
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.cps_fused_apply(
            pw.kernel_id, int(jacobian), basis.P, basis.Q, _DTYPES[u.dtype],
            u.data_ptr(), u.shape[1], conn.data_ptr(), conn.shape[0],
            qdata.data_ptr(), basis.B.data_ptr(), basis.D.data_ptr(),
            None if stash is None else stash.data_ptr(), ve.data_ptr(),
            float(a), float(b), stream,
            None if work is None else work.data_ptr(),
            0 if work is None else work.numel(), int(cluster))
    if err != 0:
        raise RuntimeError(
            f"fused_apply kernel launch failed: cuda error {err}" if err > 0
            else "fused_apply: the generic tile needs more shared memory than "
            "a block may have on this device" if err == -2
            else "fused_apply: the gmem body's workspace is missing or short"
            if err == -3
            else f"fused_apply: cluster size {cluster} refused, or the card "
            "holds no cluster of this launch" if err == -4
            else "fused_apply: no kernel for this (physics, P, Q)")


def launch_path(pw: Pointwise, basis: Basis3D, qdata,
                stash_in=None) -> str:
    """The path a launch takes, as COUNTS.by_path counts it."""
    if is_generic(pw, basis.P, basis.Q):
        return {5: "generic_gmem", 6: "generic_cluster"}.get(
            generic_body(basis.P, basis.Q, qdata.dtype), "generic")
    return copy_path(qdata, stash_in)


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused apply runs on cpu or cuda, not {t.device}")
    return t.device.type


def residual(u, conn, qdata, basis: Basis3D, phys: Physics,
             physics: str | Pointwise = "hyperFS", *, cluster: int = 0):
    """Residual E-vector and stash of `physics`: (ve (3, nelem, P3),
    stash (9, nelem, Q3) or None). CPU tensors -> plain torch; CUDA ->
    kernel. `cluster` > 0 runs the cluster body at that many CTAs a
    cluster instead of the plan's (a measurement's override: the solvers
    never pass it; refused where another body runs)."""
    pw = pointwise(physics)
    if _device_kind(u) == "cpu":
        return residual_plain(u, conn, qdata, basis, phys, pw)
    nelem = conn.shape[0]
    ve = torch.empty((3, nelem, basis.P3), dtype=u.dtype, device=u.device)
    stash = (torch.empty((9, nelem, basis.Q3), dtype=u.dtype,
                         device=u.device) if pw.stash else None)
    _check(u, conn, qdata, basis, stash, pw)
    _launch(False, u, conn, qdata, basis, stash, ve, phys, pw,
            cluster=cluster)
    COUNTS.add("residual", basis, pw.name, launch_path(pw, basis, qdata),
               nelem)
    return ve, stash


def jacobian(v, conn, qdata, stash, basis: Basis3D, phys: Physics,
             physics: str | Pointwise = "hyperFS", *, cluster: int = 0):
    """Jacobian action E-vector (3, nelem, P3) of `physics` from the
    stashed gradu (None for a physics without one). CPU tensors -> plain
    torch; CUDA -> kernel. `cluster`: as residual takes it."""
    pw = pointwise(physics)
    if _device_kind(v) == "cpu":
        return jacobian_plain(v, conn, qdata, stash, basis, phys, pw)
    _check(v, conn, qdata, basis, stash, pw)
    ve = torch.empty((3, conn.shape[0], basis.P3), dtype=v.dtype,
                     device=v.device)
    _launch(True, v, conn, qdata, basis, stash, ve, phys, pw,
            cluster=cluster)
    COUNTS.add("jacobian", basis, pw.name,
               launch_path(pw, basis, qdata, stash), conn.shape[0])
    return ve
