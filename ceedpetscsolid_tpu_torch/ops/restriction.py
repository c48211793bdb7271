"""Element restriction: L-vector <-> E-vector gather / scatter-add.
Port of ceedpetscsolid_tpu/ops/restriction.py.

The CeedElemRestriction analog (reference src/setuplibceed.c:194-240).
Component-major layout: L-vectors are (ncomp, num_nodes), E-vectors are
(ncomp, nelem, P3). Constrained (Dirichlet) DOFs are not encoded in the
indices; boundary conditions are applied by masking at the solver level.
Under the profiler the owner-sum is the span op/owner_sum, with its device
ms (utils/timing.fine).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import fine


class Restriction:
    """Gather/scatter between (ncomp, num_nodes) and (ncomp, nelem, P3).

    The transpose (scatter-add) runs as a node-centric GATHER-SUM: at setup,
    the positions in the flattened E-vector that reference each node are
    tabulated into padded (nodes_in_range, K) index blocks, one block per
    contiguous node-id range of roughly uniform multiplicity (the
    [vertices | edges | faces | cell-interiors] ranges of mesh/fespace.py:
    K = ~8 / ~4 / 2 / 1), padded with a sentinel that points at an appended
    zero. At run time each block is one index_select and a sum over K.
    Unlike `index_add_`, whose CUDA atomics add in a run-dependent order,
    this sums in a fixed order, so the operator CG sees is the same
    operator on every application.
    """

    def __init__(self, conn: np.ndarray, num_nodes: int,
                 node_ranges: list | None = None, *, device):
        self.num_nodes = int(num_nodes)
        self.nelem, self.P3 = conn.shape
        self.conn = torch.as_tensor(np.asarray(conn, np.int64), device=device)
        self._t_blocks = self._build_transpose_map(np.asarray(conn),
                                                   node_ranges, device)
        # the appended zero column by (ncomp, dtype), made once
        self._zero = {}

    def _build_transpose_map(self, conn: np.ndarray, node_ranges, device):
        flat = conn.reshape(-1).astype(np.int64)
        N = self.num_nodes
        counts = np.bincount(flat, minlength=N)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos_sorted = np.argsort(flat, kind="stable")
        sentinel = flat.size                    # extra zero slot appended
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
