"""The PetscSF runtime on torch.distributed, one process per rank.
Port of ceedpetscsolid_tpu/parallel/dist.py.

The two primitives every distributed operator application needs
(reference src/matops.c:26-60):
  * halo gather   (DMGlobalToLocal, INSERT):  g2l
  * owner-sum     (DMLocalToGlobal, ADD):     l2g_add
as `all_to_all_single` exchanges with per-peer split sizes, plus the
distributed dot products CG needs.

Each rank holds its own slice of a `partition.SpacePartition` (`RankArrays`)
at its own shapes: the JAX package pads every shard's elements to one count
because `shard_map` traces one program, which a process per rank does not
need. Owned vectors keep the JAX layout, (3, n_owned_max) with zero
padding, so owned data, the eigenvalue probe and the replicated AMG's
all-gather match the JAX package slot for slot.

The backend comes from the process group (`Comm`) and is never switched:
NCCL exchanges device tensors, one rank per card; gloo stages CUDA tensors
through pinned host memory (the CPU tests, and several ranks sharing one
card); any other backend raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as tdist

from ..ops.restriction import Restriction
from ..utils.precise import dot2
from .partition import SpacePartition

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, world: int, device) -> None:
    """Raise unless `backend` can run `world` ranks on `device`'s type:
    NCCL needs one CUDA device a rank; gloo runs on the CPU or stages CUDA
    tensors through the host; nothing else is taken."""
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL exchanges CUDA tensors, not {device}")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > have:
            raise RuntimeError(
                f"NCCL runs one rank a card: a world of {world} needs "
                f"{world} CUDA devices, {have} present (gloo runs several "
                "ranks on one card)")
    elif backend == "gloo":
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"gloo ranks run on cpu or cuda, not {device}")
    else:
        raise ValueError(f"unknown backend {backend!r}: choose from "
                         f"{BACKENDS}")


class _Pending:
    """An exchange in flight; wait() returns the received rows on the
    rank's device."""

    def __init__(self, comm, work, recv, t_start):
        self.comm, self.work, self.recv = comm, work, recv
        self.issue_s = time.perf_counter() - t_start

    def wait(self) -> torch.Tensor:
        # the host's clock counts the issue and the wait, not the compute
        # between them
        self.comm._wait("all_to_all", self.work,
                        time.perf_counter() - self.issue_s)
        return (self.recv.to(self.comm.device, non_blocking=True)
                if self.comm.stage else self.recv)


class Comm:
    """A process group on one rank's device: the collectives the driver
    uses, staged through pinned host memory under gloo with CUDA tensors.
    The device has no default: a caller that forgets it does not land on
    the CPU.

    `seconds()` gives the seconds spent in each kind of exchange, counting
    for an exchange that overlaps compute only the wait at its end. Under
    gloo they are the host's (a staged exchange first drains the stream,
    and that wait is not counted). Under NCCL a collective only enqueues
    work, so the host's clock would see the enqueue alone: there they are
    the device's, from CUDA events on the rank's stream just before and
    just after the stream waits for the collective."""

    def __init__(self, group, device):
        self.group = group if group is not None else tdist.group.WORLD
        self.rank = tdist.get_rank(self.group)
        self.world = tdist.get_world_size(self.group)
        self.backend = str(tdist.get_backend(self.group))
        self.device = torch.device(device)
        check_backend(self.backend, self.world, self.device)
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        self.nccl = self.backend == "nccl"
        kinds = ("all_to_all", "all_reduce", "all_gather")
        self._seconds = dict.fromkeys(kinds, 0.0)
        self._events = {k: [] for k in kinds}

    def seconds(self) -> dict:
        """Seconds in each kind of exchange so far (under NCCL this waits
        for the rank's stream)."""
        if any(self._events.values()):
            torch.cuda.synchronize(self.device)
            for kind, pairs in self._events.items():
                self._seconds[kind] += sum(a.elapsed_time(b)
                                           for a, b in pairs) / 1e3
                pairs.clear()
        return dict(self._seconds)

    def _wait(self, kind: str, work, t0: float) -> None:
        """Wait for `work` and add the time to `kind`: the host's since t0
        (gloo), or the rank's stream's wait for it (NCCL)."""
        if not self.nccl:
            work.wait()
            self._seconds[kind] += time.perf_counter() - t0
            return
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        work.wait()
        end.record()
        self._events[kind].append((begin, end))

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _sync(self):
        if self.stage:
            torch.cuda.current_stream(self.device).synchronize()

    def all_to_all(self, send: torch.Tensor, send_counts: list[int],
                   recv_counts: list[int]) -> _Pending:
        """Start the exchange of `send` rows ((n, c): the rows for peer p
        are the p-th run of send_counts[p] rows); the received rows arrive
        in the same layout by recv_counts."""
        self._sync()
        t0 = time.perf_counter()
        shape = (sum(recv_counts), *send.shape[1:])
        if self.stage:
            send = self._to_host(send)
            recv = torch.empty(shape, dtype=send.dtype, pin_memory=True)
        else:
            recv = torch.empty(shape, dtype=send.dtype, device=send.device)
        work = tdist.all_to_all_single(recv, send, recv_counts, send_counts,
                                       group=self.group, async_op=True)
        return _Pending(self, work, recv, t0)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the ranks (a new tensor on the rank's device)."""
        self._sync()
        t0 = time.perf_counter()
        buf = self._to_host(t) if self.stage else t.clone()
        self._wait("all_reduce", tdist.all_reduce(buf, group=self.group,
                                                  async_op=True), t0)
        return buf.to(self.device, non_blocking=True) if self.stage else buf

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's `t` (equal shapes), on the
        rank's device."""
        self._sync()
        t0 = time.perf_counter()
        src = self._to_host(t) if self.stage else t.contiguous()
        bufs = [torch.empty_like(src) for _ in range(self.world)]
        self._wait("all_gather", tdist.all_gather(bufs, src,
                                                  group=self.group,
                                                  async_op=True), t0)
        return torch.stack(bufs).to(self.device)


class _OwnerSum:
    """Fixed-order sum of received ghost contributions into owned slots.

    Row i of the received block adds to owned slot targets[i]. At setup the
    rows of each distinct slot are tabulated in ascending order into a
    padded (slots, K) block whose padding points at an appended zero row,
    as ops/restriction.Restriction does for the element scatter; at run time
    one gather and one sum over K. `index_add_` on CUDA adds in a
    run-dependent order, and PCG needs the same operator on every
    application."""

    def __init__(self, targets: np.ndarray, device):
        targets = np.asarray(targets, np.int64)
        slots, inv = np.unique(targets, return_inverse=True)
        counts = np.bincount(inv, minlength=slots.size)
        K = max(int(counts.max(initial=0)), 1)
        order = np.argsort(inv, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        idx = np.full((slots.size, K), targets.size, np.int64)
        for k in range(K):
            rows = np.nonzero(counts > k)[0]
            idx[rows, k] = order[starts[rows] + k]
        self.slots = torch.as_tensor(slots, device=device)
        self.idx = torch.as_tensor(idx, device=device)

    def add_into(self, out: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
        """out (c, n_owned) + the received rows recv (n, c), summed per
        slot in the tabulated order."""
        ext = torch.cat([recv, recv.new_zeros((1, recv.shape[1]))])
        out[:, self.slots] += ext[self.idx].sum(dim=1).T
        return out


class RankArrays:
    """One rank's slice of a SpacePartition, as tensors on its device
    (the JAX package's ShardArrays, without the element padding).

      conn         (nelem, P3) int64 local-node indices, interior first;
                   conn[:n_elem_int] indexes owned slots only
      restr_int    Restriction of the interior batch into n_owned_max slots
      restr_bnd    Restriction of the boundary batch into n_local slots
      send_slots   owned slots sent by g2l, peer by peer (send_counts)
      ghost_slots  ghost slots received by g2l, peer by peer (recv_counts)
      owned_valid  (n_owned_max,) bool
    l2g_add runs the same plan backwards: the ghost slots are sent and the
    received rows add into send_slots (`_OwnerSum`)."""

    def __init__(self, part: SpacePartition, comm: Comm):
        r, dev = comm.rank, comm.device
        self.comm = comm
        self.n_owned_max = part.n_owned_max
        self.n_local = part.n_local
        self.n_elem_int = k = part.n_elem_int
        conn = part.conn_local[r][part.elem_valid[r]].astype(np.int64)
        self.conn = torch.as_tensor(conn, device=dev)
        self.conn_int = self.conn[:k].contiguous()
        self.conn_bnd = self.conn[k:].contiguous()
        self.restr_int = Restriction(conn[:k], self.n_owned_max, device=dev) \
            if k else None
        self.restr_bnd = Restriction(conn[k:], self.n_local, device=dev) \
            if k < len(conn) else None
        own = part.pair_valid_owner[r]            # [peer, m]
        hold = part.pair_valid_holder[r]
        self.send_counts = own.sum(axis=1).tolist()
        self.recv_counts = hold.sum(axis=1).tolist()
        send = part.pair_owned_slot[r][own].astype(np.int64)
        ghost = part.pair_ghost_slot[r][hold].astype(np.int64)
        self.send_slots = torch.as_tensor(send, device=dev)
        self.ghost_slots = torch.as_tensor(ghost, device=dev)
        self.owner_sum = _OwnerSum(send, dev)
        # every rank knows the whole partition: a world without any ghost
        # pair (one rank) skips the exchange on every rank alike
        self.active = bool(part.pair_valid_owner.any())
        self.owned_valid = torch.as_tensor(part.owned_valid[r], device=dev)

    # -- halo gather (INSERT) ----------------------------------------------
    def g2l_start(self, owned: torch.Tensor):
        """Issue the ghost-value exchange of the owned block (c,
        n_owned_max); compute that reads owned slots only (the interior
        batch) can run before g2l_finish."""
        if not self.active:
            return owned, None
        send = owned[:, self.send_slots].T.contiguous()
        return owned, self.comm.all_to_all(send, self.send_counts,
                                           self.recv_counts)

    def g2l_finish(self, started) -> torch.Tensor:
        """(c, n_local): the owned block, the received ghosts, zero trash."""
        owned, pending = started
        local = owned.new_zeros((owned.shape[0], self.n_local))
        local[:, : self.n_owned_max] = owned
        if pending is not None:
            local[:, self.ghost_slots] = pending.wait().T
        return local

    def g2l(self, owned: torch.Tensor) -> torch.Tensor:
        return self.g2l_finish(self.g2l_start(owned))

    # -- owner-sum (ADD) ---------------------------------------------------
    def l2g_add(self, local: torch.Tensor) -> torch.Tensor:
        """(c, n_local) -> (c, n_owned_max): the owned part plus the ghost
        contributions of the other ranks, summed in a fixed order."""
        out = local[:, : self.n_owned_max].clone()
        if self.active:
            send = local[:, self.ghost_slots].T.contiguous()
            recv = self.comm.all_to_all(send, self.recv_counts,
                                        self.send_counts).wait()
            out = self.owner_sum.add_into(out, recv)
        return torch.where(self.owned_valid, out, 0.0)

    # -- element gather / scatter ------------------------------------------
    def gather_elements(self, local: torch.Tensor) -> torch.Tensor:
        """(c, n_local) -> (c, nelem, P3) E-vector."""
        return local[:, self.conn]

    def scatter_elements(self, ve: torch.Tensor) -> torch.Tensor:
        """(c, nelem, P3) -> (c, n_local), summed in a fixed order (the
        boundary batch's Restriction, the interior batch's added to its
        owned slots)."""
        k = self.n_elem_int
        out = (self.restr_bnd.scatter_add(ve[:, k:].contiguous())
               if self.restr_bnd is not None else
               ve.new_zeros((ve.shape[0], self.n_local)))
        if self.restr_int is not None:
            out[:, : self.n_owned_max] += self.restr_int.scatter_add(
                ve[:, :k].contiguous())
        return out


def ddot(a: torch.Tensor, b: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Distributed dot of owned blocks (padding is zero by invariant): each
    rank's float64 dot2, then one float64 all_reduce; a 0-dim float64
    tensor on the rank's device. The JAX package sums a compensated (hi,
    lo) float32 pair instead (the TPU has no float64 vector unit); in
    float64 the two are the same arithmetic."""
    return comm.all_reduce(dot2(a, b))


def dnorm(a: torch.Tensor, comm: Comm) -> torch.Tensor:
    return torch.sqrt(ddot(a, a, comm))
