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
from ..utils.timing import count, span
from .partition import SpacePartition

BACKENDS = ("nccl", "gloo")
KINDS = ("all_to_all", "all_reduce", "all_gather")
# each kind's spans: the host's issue of the exchange and its wait
SPANS = {k: (f"dist/{k}/issue", f"dist/{k}/wait") for k in KINDS}


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
    just after the stream waits for the collective (event pairs made once
    and used again once `seconds()` has read them).

    Each exchange is two spans of utils/timing, dist/<kind>/issue and
    dist/<kind>/wait (the host's clock: under NCCL the wait only enqueues
    the stream's wait, whose device time `seconds()` gives), and adds to
    the counters dist.exchanges and dist.bytes (the bytes this rank
    sends)."""

    def __init__(self, group, device):
        self.group = group if group is not None else tdist.group.WORLD
        self.rank = tdist.get_rank(self.group)
        self.world = tdist.get_world_size(self.group)
        self.backend = str(tdist.get_backend(self.group))
        self.device = torch.device(device)
        check_backend(self.backend, self.world, self.device)
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        self.nccl = self.backend == "nccl"
        self._seconds = dict.fromkeys(KINDS, 0.0)
        self._events = {k: [] for k in KINDS}
        self._spare = []

    def seconds(self) -> dict:
        """Seconds in each kind of exchange so far (under NCCL this waits
        for the rank's stream)."""
        if any(self._events.values()):
            torch.cuda.synchronize(self.device)
            for kind, pairs in self._events.items():
                self._seconds[kind] += sum(a.elapsed_time(b)
                                           for a, b in pairs) / 1e3
                self._spare.extend(pairs)
                pairs.clear()
        return dict(self._seconds)

    def _issued(self, t: torch.Tensor) -> None:
        count("dist.exchanges")
        count("dist.bytes", t.numel() * t.element_size())

    def _wait(self, kind: str, work, t0: float) -> None:
        """Wait for `work` and add the time to `kind`: the host's since t0
        (gloo), or the rank's stream's wait for it (NCCL)."""
        with span(SPANS[kind][1]):
            if not self.nccl:
                work.wait()
                self._seconds[kind] += time.perf_counter() - t0
                return
            begin, end = (self._spare.pop() if self._spare else
                          (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
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
                   recv_counts: list[int], out=None) -> _Pending:
        """Start the exchange of `send` rows ((n, c): the rows for peer p
        are the p-th run of send_counts[p] rows); the received rows arrive
        in the same layout by recv_counts, in `out` where given (a
        contiguous tensor of those rows on the rank's device; a staged
        exchange receives into the host and leaves it alone)."""
        self._sync()
        t0 = time.perf_counter()
        with span(SPANS["all_to_all"][0]):
            shape = (sum(recv_counts), *send.shape[1:])
            if self.stage:
                send = self._to_host(send)
                recv = torch.empty(shape, dtype=send.dtype, pin_memory=True)
            elif out is not None:
                recv = out
            else:
                recv = torch.empty(shape, dtype=send.dtype,
                                   device=send.device)
            work = tdist.all_to_all_single(recv, send, recv_counts,
                                           send_counts, group=self.group,
                                           async_op=True)
        self._issued(send)
        return _Pending(self, work, recv, t0)

    def all_reduce(self, t: torch.Tensor, own: bool = False) -> torch.Tensor:
        """Sum of `t` over the ranks on the rank's device: a new tensor, or
        where `own` (nothing else reads `t`) `t` itself, summed in place."""
        self._sync()
        t0 = time.perf_counter()
        with span(SPANS["all_reduce"][0]):
            buf = (self._to_host(t) if self.stage else t if own else
                   t.clone())
            work = tdist.all_reduce(buf, group=self.group, async_op=True)
        self._issued(buf)
        self._wait("all_reduce", work, t0)
        return buf.to(self.device, non_blocking=True) if self.stage else buf

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's `t` (equal shapes), on the
        rank's device."""
        self._sync()
        t0 = time.perf_counter()
        with span(SPANS["all_gather"][0]):
            src = self._to_host(t) if self.stage else t.contiguous()
            bufs = [torch.empty_like(src) for _ in range(self.world)]
            work = tdist.all_gather(bufs, src, group=self.group,
                                    async_op=True)
        self._issued(src)
        self._wait("all_gather", work, t0)
        return torch.stack(bufs).to(self.device)


class _OwnerSum:
    """Fixed-order sum of received ghost contributions into owned slots.

    Row i of the received block adds to owned slot targets[i]. At setup the
    rows of each owned slot are tabulated in ascending order into a padded
    (n_owned, K) block whose padding points at the row after the received
    ones, kept zero, as ops/restriction.Restriction does for the element
    scatter; at run time one gather, a sum over K (where K > 1) and one
    add, over every owned slot (a slot no peer adds to adds zero).
    `index_add_` on CUDA adds in a run-dependent order, and PCG needs the
    same operator on every application.

    The received rows land in `buf`'s first rows: the exchange's own
    buffer, made once (its last row stays zero; the stream's order keeps
    one application's rows until its gather has read them)."""

    def __init__(self, targets: np.ndarray, n_owned: int, ncomp: int,
                 dtype, device):
        targets = np.asarray(targets, np.int64)
        counts = np.bincount(targets, minlength=n_owned)
        K = max(int(counts.max(initial=0)), 1)
        order = np.argsort(targets, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        idx = np.full((n_owned, K), targets.size, np.int64)
        for k in range(K):
            rows = np.nonzero(counts > k)[0]
            idx[rows, k] = order[starts[rows] + k]
        self.idx = torch.as_tensor(idx[:, 0] if K == 1 else idx,
                                   device=device)
        self.buf = torch.zeros((targets.size + 1, ncomp), dtype=dtype,
                               device=device)

    def add_into(self, owned: torch.Tensor) -> torch.Tensor:
        """owned (c, n_owned) + the received rows in buf[:-1], summed per
        slot in the tabulated order."""
        rows = self.buf[self.idx]
        return owned + (rows if rows.dim() == 2 else rows.sum(dim=1)).T


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
    received rows add into send_slots (`_OwnerSum`). Each direction is a
    few kernels besides its exchange: the rows to send are one gather, the
    local block one concatenation, the owner-sum one gather and one add."""

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
        # the owner-sum's plan and buffer by (components, dtype), made at
        # first use
        self._send_np = send
        self.owner_sum = {}
        # g2l's local block is [owned | received rows | zero columns] put
        # in local slot order by `_g2l_order` (None where that is the
        # order they come in)
        order = np.concatenate([np.arange(self.n_owned_max), ghost])
        rest = np.setdiff1d(np.arange(self.n_local), order)
        order = np.argsort(np.concatenate([order, rest]))
        self._g2l_order = (
            None if np.array_equal(order, np.arange(self.n_local)) else
            torch.as_tensor(order, device=dev))
        self._g2l_pad = {}
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
        return owned, self.comm.all_to_all(owned.T[self.send_slots],
                                           self.send_counts,
                                           self.recv_counts)

    def g2l_finish(self, started) -> torch.Tensor:
        """(c, n_local): the owned block, the received ghosts, zero trash."""
        owned, pending = started
        parts = [owned]
        if pending is not None:
            parts.append(pending.wait().T)
        n = self.n_local - sum(p.shape[1] for p in parts)
        key = (owned.shape[0], n, owned.dtype)
        if n and key not in self._g2l_pad:
            self._g2l_pad[key] = owned.new_zeros((owned.shape[0], n))
        local = torch.cat(parts + [self._g2l_pad[key]] if n else parts,
                          dim=1)
        return local if self._g2l_order is None else \
            local[:, self._g2l_order]

    def g2l(self, owned: torch.Tensor) -> torch.Tensor:
        return self.g2l_finish(self.g2l_start(owned))

    # -- owner-sum (ADD) ---------------------------------------------------
    def l2g_add(self, local: torch.Tensor) -> torch.Tensor:
        """(c, n_local) -> (c, n_owned_max): the owned part plus the ghost
        contributions of the other ranks, summed in a fixed order."""
        out = local[:, : self.n_owned_max]
        if self.active:
            key = (local.shape[0], local.dtype)
            osum = self.owner_sum.get(key)
            if osum is None:
                osum = self.owner_sum[key] = _OwnerSum(
                    self._send_np, self.n_owned_max, *key, local.device)
            buf = osum.buf[:-1]
            recv = self.comm.all_to_all(local.T[self.ghost_slots],
                                        self.recv_counts, self.send_counts,
                                        out=buf).wait()
            if recv is not buf:                 # staged through the host
                buf.copy_(recv)
            out = osum.add_into(out)
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
    return comm.all_reduce(dot2(a, b), own=True)


def dnorm(a: torch.Tensor, comm: Comm) -> torch.Tensor:
    return torch.sqrt(ddot(a, a, comm))
