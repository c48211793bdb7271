"""Element restriction: L-vector <-> E-vector gather / scatter-add.
Port of ceedpetscsolid_tpu/ops/restriction.py.

The CeedElemRestriction analog (reference src/setuplibceed.c:194-240).
Component-major layout: L-vectors are (ncomp, num_nodes), E-vectors are
(ncomp, nelem, P3). Constrained (Dirichlet) DOFs are not encoded in the
indices; boundary conditions are applied by masking at the solver level.
Under the profiler the owner-sum is the span op/owner_sum, with its device
ms (utils/timing.fine). Every owner-sum counts `restr.owner_sum_calls`, and
every launch of the CUDA kernel `restr.owner_sum_kernel`, in the open
request.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.timing import count, fine

_DTYPES = {torch.float32: 0, torch.float64: 1}


def csr_table(conn: np.ndarray, num_nodes: int):
    """The transpose of `conn` as a node-sorted CSR table, int32:
    (offsets (num_nodes + 1,), positions (conn.size,)). Node n's positions
    in the flattened (nelem, P3) E-vector plane are
    positions[offsets[n]:offsets[n + 1]], ascending."""
    flat = np.asarray(conn).reshape(-1).astype(np.int64)
    if flat.size >= 2 ** 31 or num_nodes >= 2 ** 31:
        raise ValueError(f"{flat.size} positions, {num_nodes} nodes: the "
                         "owner-sum's table indexes with int32")
    offsets = np.zeros(num_nodes + 1, np.int32)
    np.cumsum(np.bincount(flat, minlength=num_nodes), out=offsets[1:])
    return offsets, np.argsort(flat, kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=None)
def _library():
    """Build (first use) and load the kernel library."""
    from ..csrc.build import build

    path, _ = build()
    lib = ctypes.CDLL(str(path))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.cps_owner_sum.argtypes = [
        c_int, c_ptr, ctypes.c_longlong,       # f64, ve, its plane
        c_ptr, c_ptr, c_int, c_int,            # offsets, positions, N, ncomp
        c_ptr, c_ptr,                          # out, stream
    ]
    lib.cps_owner_sum.restype = c_int
    return lib


class Restriction:
    """Gather/scatter between (ncomp, num_nodes) and (ncomp, nelem, P3).

    The transpose (scatter-add) runs as a node-centric GATHER-SUM over
    `csr_table`, each node's values summed in a fixed order. On the card
    it is one launch of csrc/owner_sum.cu (one thread a node; the node's
    k-th position into running sum k mod 4, each from +0.0, then
    (s0 + s1) + (s2 + s3)). On the CPU it runs the plain
    version: the positions padded into (nodes_in_range, K) index blocks,
    one block per contiguous node-id range of roughly uniform multiplicity
    (the [vertices | edges | faces | cell-interiors] ranges of
    mesh/fespace.py: K = ~8 / ~4 / 2 / 1), the padding a sentinel that
    points at an appended zero; each block is one index_select and a sum
    over K. Unlike `index_add_`, whose CUDA atomics add in a run-dependent
    order, both sum in a fixed order, so the operator CG sees is the same
    operator on every application.
    """

    def __init__(self, conn: np.ndarray, num_nodes: int,
                 node_ranges: list | None = None, *, device):
        self.num_nodes = int(num_nodes)
        self.nelem, self.P3 = conn.shape
        self.conn = torch.as_tensor(np.asarray(conn, np.int64), device=device)
        offsets, positions = csr_table(conn, self.num_nodes)
        if self.conn.device.type == "cuda":
            self.offsets = torch.as_tensor(offsets, device=device)
            self.positions = torch.as_tensor(positions, device=device)
        else:
            self._t_blocks = self._build_transpose_map(offsets, positions,
                                                       node_ranges, device)
            # the appended zero column by (ncomp, dtype), made once
            self._zero = {}

    def _build_transpose_map(self, offsets, positions, node_ranges, device):
        N = self.num_nodes
        counts = np.diff(offsets)
        starts = offsets[:-1]
        pos_sorted = positions.astype(np.int64)
        sentinel = pos_sorted.size              # extra zero slot appended
        blocks = []
        for a, b in node_ranges or [(0, N)]:
            if b <= a:
                continue
            K = max(int(counts[a:b].max(initial=0)), 1)
            idx = np.full((b - a, K), sentinel, dtype=np.int64)
            for k in range(K):
                rows = np.nonzero(counts[a:b] > k)[0]
                idx[rows, k] = pos_sorted[starts[a:b][rows] + k]
            blocks.append((K, torch.as_tensor(idx.reshape(-1), device=device)))
        return blocks

    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """(ncomp, num_nodes) -> (ncomp, nelem, P3)."""
        return u[:, self.conn]

    def scatter_add(self, ve: torch.Tensor) -> torch.Tensor:
        """(ncomp, nelem, P3) -> (ncomp, num_nodes), summed over elements."""
        count("restr.owner_sum_calls")
        if ve.device.type == "cuda":
            return self._scatter_add_kernel(ve)
        with fine("op/owner_sum", stream=ve.device):
            ncomp = ve.shape[0]
            key = (ncomp, ve.dtype)
            zero = self._zero.get(key)
            if zero is None:
                zero = self._zero[key] = ve.new_zeros((ncomp, 1))
            ext = torch.cat([ve.reshape(ncomp, -1), zero], dim=1)
            parts = [ext.index_select(1, idx).reshape(ncomp, -1, K).sum(dim=2)
                     for K, idx in self._t_blocks]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _scatter_add_kernel(self, ve: torch.Tensor) -> torch.Tensor:
        """One launch of cps_owner_sum on ve's device, which must be the
        restriction's, and its current stream. The op/owner_sum span holds
        the launch (and a copy of a strided ve) alone, so that its events
        bracket the device's work and not the host's allocation."""
        f64 = _DTYPES.get(ve.dtype)
        if f64 is None or ve.shape[1:] != (self.nelem, self.P3):
            raise ValueError(f"the owner-sum kernel takes float32/float64 "
                             f"(ncomp, {self.nelem}, {self.P3}), got "
                             f"{ve.dtype} {tuple(ve.shape)}")
        dev, ncomp = ve.device, ve.shape[0]
        out = torch.empty((ncomp, self.num_nodes), dtype=ve.dtype, device=dev)
        lib = _library()
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        with torch.cuda.device(dev), fine("op/owner_sum", stream=dev):
            ve = ve.contiguous()
            err = lib.cps_owner_sum(
                f64, ve.data_ptr(), self.nelem * self.P3,
                self.offsets.data_ptr(), self.positions.data_ptr(),
                self.num_nodes, ncomp, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"owner-sum kernel: cuda error {err}" if err > 0
                               else "owner-sum kernel: arguments refused")
        count("restr.owner_sum_kernel")
        return out
