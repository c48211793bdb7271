"""Fixed-order sparse products and level data for the AMG's value refresh
on the device (solve/amg.py `AMGPreconditioner.refresh`).

After the first native setup, every pattern of the hierarchy is frozen:
the fine matrix's (CSRAssembler's), each prolongator P and its transpose,
each Galerkin product A P and P^T (A P). So each product C = A B is a fixed
bilinear function of the two value vectors: slot (i, k) of C sums
a_ij b_jk over the j of row i of A. `plan_product` lists the terms once,
as (index into A's values, index into B's values) pairs; a refresh is then
gathers, one multiply and the sum of each slot's terms in ascending j, left
to right: the order in which csrc/amg.cpp's spgemm adds them, so the
float64 values are the native refresh's, bit for bit.

The terms are laid out rank-major: first the first term of every slot,
then the second term of every slot that has two, and so on, the slots in
descending order of their term count, so that the slots holding an r-th
term are a prefix. The sum is then one slice add a rank, in a fixed order,
with no atomics: the AMG sees the same values from run to run.

`lambda_max` and `lcg_start` are the device form of est_lambda_max,
`sym_pinv` the device form of np.linalg.pinv(M, hermitian=True).
"""

from __future__ import annotations

import numpy as np
import torch

# terms expanded at once while planning and gathered at once while
# refreshing: bounds the planning's transient memory and the refresh's
# workspace (8M terms: 64 MB a float64 vector)
CHUNK = 1 << 23


def rows_of(rowptr: torch.Tensor) -> torch.Tensor:
    """The row of every entry of a CSR pattern."""
    n = rowptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=rowptr.device), rowptr.diff())


def transpose(rowptr, colind, ncols):
    """(rowptr, colind) of A^T and the permutation that takes A's values to
    A^T's, each row of A^T in ascending column (csrc/amg.cpp's transpose)."""
    n = rowptr.numel() - 1
    rows = rows_of(rowptr)
    perm = torch.argsort(colind * n + rows)         # the keys are distinct
    t_rowptr = torch.zeros(ncols + 1, dtype=torch.int64, device=rowptr.device)
    t_rowptr[1:] = torch.cumsum(torch.bincount(colind, minlength=ncols), 0)
    return t_rowptr, rows[perm], perm


def _pattern(rows, cols, n):
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return rowptr, cols


class Product:
    """The plan of one fixed-pattern product C = A B.

    li, ri: (terms,) int32, each term's index into A's and into B's value
    vector, rank-major (the module's docstring); widths[r]: the slots that
    have more than r terms; pos: (slots,) where C's CSR slot s sits in the
    vector __call__ returns; rowptr, colind: C's pattern. Whole ranks are
    gathered together, at most CHUNK terms a block (or one rank): `bind`
    lays the blocks over a shared float64 workspace once."""

    def __init__(self, li, ri, widths, pos, rowptr, colind):
        self.li, self.ri, self.pos = li, ri, pos
        self.rowptr, self.colind = rowptr, colind
        self.blocks, start, ws = [], 0, []
        for w in widths:
            if ws and sum(ws) + w > CHUNK:
                self.blocks.append((start, ws))
                start, ws = start + sum(ws), []
            ws.append(w)
        if ws:
            self.blocks.append((start, ws))
        self.nslots = widths[0] if widths else 0
        self._out = self._ops = None

    @property
    def block_terms(self) -> int:
        """The terms of the largest block."""
        return max((sum(ws) for _, ws in self.blocks), default=0)

    def bind(self, work: torch.Tensor) -> None:
        """Lay every block's gathers, product and slice adds over work
        ((3, >= block_terms) float64, shared by products that run one after
        another) and an output of the product's own, once, so that a call
        makes no tensor and no view: it is launch-bound."""
        self._out = work.new_empty(self.nslots)
        self._ops = []
        for start, ws in self.blocks:
            n = sum(ws)
            ga, gb, prod = work[0, :n], work[1, :n], work[2, :n]
            offs = np.cumsum([0] + ws)
            adds = [(self._out[:w], prod[o:o + w]) for w, o in zip(ws, offs)]
            self._ops.append((self.li[start:start + n],
                              self.ri[start:start + n], ga, gb, prod, adds))

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """C's values from A's (a) and B's (b), in `pos` order: each slot's
        terms multiplied and added in ascending j, the first term first (0
        + t would turn a -0.0 product into the +0.0 that spgemm does not
        keep). The result is the product's own buffer, which the next call
        overwrites."""
        first = True
        for li, ri, ga, gb, prod, adds in self._ops:
            torch.index_select(a, 0, li, out=ga)
            torch.index_select(b, 0, ri, out=gb)
            torch.mul(ga, gb, out=prod)
            for out, terms in adds:
                if first:
                    out.copy_(terms)
                    first = False
                else:
                    out.add_(terms)
        return self._out


def plan_product(a_rowptr, a_colind, b_rowptr, b_colind, ncols,
                 b_pos=None) -> Product:
    """The plan of C = A B from the CSR patterns of A (n x m) and B
    (m x ncols), int64 tensors on the device the plan is for; each row of
    A in ascending column. b_pos: where B's value k sits in the vector the
    plan's caller passes for B (default: at k).

    Two passes over blocks of A's rows, each expanding at most CHUNK terms
    (or one row): the first counts each slot's terms, the second puts each
    term in its rank-major place, so only one block's terms are held at a
    time beside the plan."""
    dev = a_rowptr.device
    n = a_rowptr.numel() - 1
    a_rows = rows_of(a_rowptr)
    tlen = b_rowptr.diff()[a_colind]            # the terms of each A entry
    tbefore = torch.cumsum(tlen, 0) - tlen
    row_terms = torch.cat([tbefore, tlen.sum().view(1)])[a_rowptr]
    row_terms, a_ptr = row_terms.cpu().numpy(), a_rowptr.cpu().numpy()
    blocks, r0 = [], 0
    while r0 < n:
        r1 = int(np.searchsorted(row_terms, row_terms[r0] + CHUNK,
                                 side="right")) - 1
        blocks.append((r0, min(max(r1, r0 + 1), n)))
        r0 = blocks[-1][1]

    def terms(r0, r1):
        """The block's terms, each slot's in ascending j: within the block
        they come out in (row, j) order, and a stable sort by (row, column
        of C) keeps that order inside a slot. (A's value index, B's value
        index, the key of C's slot: row offset x ncols + column.)"""
        e0, e1 = int(a_ptr[r0]), int(a_ptr[r1])
        ent = torch.repeat_interleave(torch.arange(e0, e1, device=dev),
                                      tlen[e0:e1])
        local = torch.arange(ent.numel(), device=dev) - (
            tbefore[ent] - (tbefore[e0] if e1 > e0 else 0))
        bidx = b_rowptr[a_colind[ent]] + local
        key, perm = torch.sort((a_rows[ent] - r0) * ncols + b_colind[bidx],
                               stable=True)
        return ent[perm], bidx[perm], key

    keys, counts = [], []
    for r0, r1 in blocks:
        ukey, cnt = torch.unique_consecutive(terms(r0, r1)[2],
                                             return_counts=True)
        keys.append(ukey + r0 * ncols)
        counts.append(cnt)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    keys, counts = torch.cat(keys or [empty]), torch.cat(counts or [empty])
    nslots = keys.numel()
    rowptr, colind = _pattern(keys // ncols, keys % ncols, n)
    if nslots == 0:
        return Product(empty.int(), empty.int(), [], empty, rowptr, colind)
    order = torch.argsort(counts, descending=True, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(nslots, device=dev)
    kmax = int(counts.max())
    widths = nslots - torch.cumsum(torch.bincount(counts,
                                                  minlength=kmax + 1), 0)[:kmax]
    roff = torch.cumsum(widths, 0) - widths
    total = int(widths.sum())
    li = torch.empty(total, dtype=torch.int32, device=dev)
    ri = torch.empty(total, dtype=torch.int32, device=dev)
    slot0 = 0
    for r0, r1 in blocks:
        ent, bidx, key = terms(r0, r1)
        _, inv, cnt = torch.unique_consecutive(key, return_inverse=True,
                                               return_counts=True)
        rank = torch.arange(key.numel(), device=dev) - (
            torch.cumsum(cnt, 0) - cnt)[inv]
        dest = roff[rank] + pos[inv + slot0]
        li[dest] = ent.int()
        ri[dest] = (bidx if b_pos is None else b_pos[bidx]).int()
        slot0 += cnt.numel()
    return Product(li, ri, widths.tolist(), pos, rowptr, colind)


def lcg_start(n: int) -> np.ndarray:
    """est_lambda_max's start vector (csrc/amg.cpp): the first n draws of
    its 64-bit LCG, each in [-0.5, 0.5) (exact in float64)."""
    out = np.empty(n)
    seed, mask = 0x9E3779B97F4A7C15, (1 << 64) - 1
    for i in range(n):
        seed = (seed * 6364136223846793005 + 1442695040888963407) & mask
        out[i] = (seed >> 11) / 9007199254740992.0 - 0.5
    return out


def lambda_max(ell_vals, ell_col, dinv, x, steps: int = 12):
    """est_lambda_max of csrc/amg.cpp on the device, with no sync: `steps`
    power iterations on D^-1 A from x, A as padded ELL (values, columns);
    a zero iterate stops the estimate where it is. A 0-d float64 tensor."""
    n, K = ell_vals.shape
    col = ell_col.reshape(-1)
    lam = torch.ones((), dtype=torch.float64, device=x.device)
    stopped = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(steps):
        nrm = torch.linalg.vector_norm(x)
        stopped = stopped | (nrm == 0)
        x = torch.where(stopped, 0.0, x / nrm)
        y = dinv * (ell_vals * x.index_select(0, col).view(n, K)).sum(1)
        lam = torch.where(stopped, lam, torch.dot(x, y))
        x = y
    return lam.clamp_min(1e-12)


def sym_pinv(M: torch.Tensor) -> torch.Tensor:
    """np.linalg.pinv(M, hermitian=True) on M's device: the eigenpairs of
    M's lower triangle, eigenvalues at or below 1e-15 of the largest in
    magnitude dropped; where eigh does not converge, the SVD pseudo-inverse
    of M + 1e-12 max|M| I (the host path's fallback, solve/amg.py)."""
    try:
        w, V = torch.linalg.eigh(M)
    except torch.linalg.LinAlgError:
        eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        return torch.linalg.pinv(M + 1e-12 * eye * M.abs().max(), rtol=1e-15)
    aw = w.abs()
    inv = torch.where(aw > 1e-15 * aw.max(), 1.0 / w, 0.0)
    return (V * inv) @ V.T
