"""AMG V-cycle on the device over a natively built hierarchy.
Port of ceedpetscsolid_tpu/solve/amg.py.

The C++ library (csrc/amg.cpp, bound by native.py) does the
smoothed-aggregation SETUP on the assembled p = 1 matrix: the analog of the
reference's GAMG coarse solve (elasticity.c:568-585) and of its whole
preconditioner at degree 1 (elasticity.c:519-521). This module copies the
hierarchy into tensors on the problem's device and applies one V-cycle
there, a fixed linear operation in its input (a valid stationary
preconditioner for the outer CG).

After the first setup the hierarchy's structure is frozen: a refresh with a
matrix of the same pattern recomputes values only, and the index tensors on
the device stay as they are. Given the assembler its matrices come from
(`setup(A, source)`), the first setup also plans the refresh on the device
(solve/galerkin.py), and every later refresh (`refresh`) computes the
levels' values, diagonals, lambda_max and coarse inverse there from the
fine values, in float64: none go to the host. Without it (the distributed
driver) a refresh is native (amg_refresh) and uploads the levels again.

Level representations (`_level_rep`): level 0 is 'mf' when the hierarchy
was built with top_mf=True (the caller's matrix-free p = 1 apply, which on
CUDA is the fused element-apply kernel at (P, Q) = (2, 2)); a level with
n <= dense_n is a dense (n, n) matrix (torch.matmul, as the JAX package left
these products to XLA); any other level is padded ELL; the coarsest is
solved by its dense pseudo-inverse.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.timing import count, span, sync
from . import galerkin


def _ell_map(n, rowptr):
    """CSR -> ELL slot map: src[i, k] = rowptr[i] + k (clamped) and a
    validity mask. Shared by structure extraction and value refresh."""
    counts = np.diff(rowptr)
    K = int(counts.max(initial=1))
    src = rowptr[:-1, None] + np.arange(K)[None, :]
    mask = np.arange(K)[None, :] < counts[:, None]
    return np.where(mask, src, 0), mask, K


def ell_matvec(idx, vals, x):
    """y[i] = sum_k vals[i, k] * x[idx[i, k]] (padding: value 0 at col 0)."""
    return torch.sum(vals * x[idx], dim=1)


class AMGPreconditioner:
    """Owns the native hierarchy handle and the device tensors of its levels.

    data = {"levels": [dict per level], "coarse_inv": (nc, nc) tensor}; a
    level dict holds "a_idx"/"a_val" (ELL) or "a_dense", "dinv", "lam" (a
    float), and the transfer to the next level as "p_dense"/"pt_dense" or
    "p_idx"/"p_val"/"pt_idx"/"pt_val"."""

    def __init__(self, dtype, device, theta: float = 0.0,
                 max_levels: int = 10, coarse_size: int = 600,
                 smooth_its: int = 2, top_mf: bool = False,
                 dense_n: int = 4096):
        self.dtype = dtype
        self.device = torch.device(device)
        self.theta = theta
        self.max_levels = max_levels
        self.coarse_size = coarse_size
        self.smooth_its = smooth_its
        self.top_mf = top_mf
        self.dense_n = dense_n
        self.handle = None
        self._pattern = None
        self._struct = None       # host-side frozen structure + ELL maps
        self._free = None
        self.data = None
        self._plan = None         # the device refresh's plans, by level
        self._source = None       # the assembler they take values from

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=dtype or self.dtype, device=self.device)

    # -- host-side setup / refresh -----------------------------------------
    def setup(self, A: sp.csr_matrix, source=None):
        """Build the hierarchy of A, or refresh its values when A has the
        pattern of the last setup (`build`), and bring its levels to the
        device (`upload`). source: the CSRAssembler that A came from; given,
        a new hierarchy also plans the device refresh of the values it
        assembles (span pc/amg/plan; `refreshes_from`, `refresh`)."""
        self.build(A)
        self.upload()
        if source is not None and self._plan is None:
            with span("pc/amg/plan"):
                self._plan = self._plan_refresh()
            self._source = source

    def refreshes_from(self, source) -> bool:
        """Whether `refresh` takes source's values: the hierarchy exists
        and was built on its pattern."""
        return self._plan is not None and self._source is source

    def build(self, A: sp.csr_matrix):
        """The native setup of A's hierarchy, or of its values only when A
        has the pattern of the last build (span pc/amg/native)."""
        from ..native import lib

        with span("pc/amg/native"):
            L = lib()
            A = A.tocsr()
            A.sort_indices()
            n = A.shape[0]
            rowptr = A.indptr.astype(np.int64)
            colind = A.indices.astype(np.int32)
            vals = A.data.astype(np.float64)
            if self.handle is not None and not (
                    np.array_equal(self._pattern[0], rowptr)
                    and np.array_equal(self._pattern[1], colind)):
                # pattern changed (CSRAssembler never does this): rebuild
                # from scratch rather than refresh a hierarchy of another
                # pattern
                self._free()
                self.handle = self._struct = self._free = None
            if self.handle is None:
                self._plan = self._source = None
                self.handle = ctypes.c_void_p(L.amg_setup(
                    n, np.int64(vals.size), rowptr, colind, vals,
                    float(self.theta), int(self.max_levels),
                    int(self.coarse_size)))
                self._free = weakref.finalize(self, L.amg_free, self.handle)
                self._pattern = (rowptr, colind)
            else:
                L.amg_refresh(self.handle, vals)

    def upload(self):
        """The levels' extraction from the native hierarchy and their
        upload, synchronised (span pc/amg/upload)."""
        from ..native import lib

        with span("pc/amg/upload"):
            if self._struct is not None:
                self._extract_values(lib())
            else:
                self._extract(lib())
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _level_rep(self, l: int, nlev: int, n: int) -> str:
        """'none' (coarsest: coarse_inv), 'mf' (level 0 through the
        caller's matrix-free apply), 'dense' or 'ell'."""
        if l == nlev - 1:
            return "none"
        if l == 0 and self.top_mf:
            return "mf"
        if n <= self.dense_n:
            return "dense"
        return "ell"

    def _dinv(self, diag):
        return self._t(np.where(diag != 0, 1.0 / np.where(diag == 0, 1, diag),
                                1.0))

    def _extract_values(self, L):
        """A's values, the diagonals, lambda_max and the coarse inverse of
        every level; after the first setup a refresh changes only these,
        over the frozen structure."""
        levels = self.data["levels"]
        for l, st in enumerate(self._struct):
            vals, diag, lam = st["vals"], st["diag"], st["lam"]
            L.amg_get_matrix(self.handle, l, st["rowptr"], st["colind"], vals,
                             diag, lam)
            e = levels[l]
            if st["rep"] == "ell":
                e["a_val"] = self._t(np.where(st["mask"], vals[st["src"]],
                                              0.0))
            elif st["rep"] == "dense":
                e["a_dense"] = self._t(sp.csr_matrix(
                    (vals, st["colind"], st["rowptr"]),
                    shape=(st["n"], st["n"])).toarray())
            if st["rep"] != "none":
                e["dinv"] = self._dinv(diag)
                e["lam"] = float(lam[0])
        self.data["coarse_inv"] = self._coarse_inv(L)

    def _coarse_inv(self, L):
        nc = self._coarse_n
        dense = np.zeros(nc * nc, np.float64)
        L.amg_coarse_dense(self.handle, dense)
        M = dense.reshape(nc, nc)
        if not np.isfinite(M).all():
            raise FloatingPointError(
                "AMG coarse matrix has non-finite entries (check the element "
                "matrices / stash feeding CSRAssembler)")
        # Galerkin coarse matrices are symmetric: the eigh-based pinv, with
        # the SVD pinv of a regularised matrix where eigh does not converge
        try:
            coarse_inv = np.linalg.pinv(M, hermitian=True)
        except np.linalg.LinAlgError:
            coarse_inv = np.linalg.pinv(
                M + 1e-12 * np.eye(nc) * np.abs(M).max())
        return self._t(coarse_inv)

    def _extract(self, L):
        """The frozen structure of the first setup (level patterns, ELL
        maps, transfers), then its values through _extract_values."""
        h = self.handle
        nlev = L.amg_num_levels(h)
        levels = []
        self._struct = []
        for l in range(nlev):
            dims = np.zeros(4, np.int64)
            L.amg_level_dims(h, l, dims)
            n, annz, pnnz, pcols = (int(d) for d in dims)
            rowptr = np.zeros(n + 1, np.int64)
            colind = np.zeros(max(annz, 1), np.int32)
            vals = np.zeros(max(annz, 1), np.float64)
            diag = np.zeros(n, np.float64)
            lam = np.zeros(1, np.float64)
            L.amg_get_matrix(h, l, rowptr, colind, vals, diag, lam)
            rep = self._level_rep(l, nlev, n)
            st = {"rowptr": rowptr, "colind": colind, "vals": vals,
                  "diag": diag, "lam": lam, "n": n, "rep": rep}
            entry = {}
            if rep == "ell":
                src, mask, _ = _ell_map(n, rowptr)
                st["src"], st["mask"] = src, mask
                entry["a_idx"] = self._t(np.where(mask, colind[src], 0),
                                         torch.int64)
            self._struct.append(st)
            if l < nlev - 1 and pnnz > 0:
                prow = np.zeros(n + 1, np.int64)
                pcol = np.zeros(pnnz, np.int32)
                pval = np.zeros(pnnz, np.float64)
                L.amg_get_prolongator(h, l, prow, pcol, pval)
                P = sp.csr_matrix((pval, pcol, prow), shape=(n, pcols))
                if n <= self.dense_n:
                    # prolongator values are frozen across refreshes, so
                    # dense transfers cost nothing after the first setup
                    pd = P.toarray()
                    entry["p_dense"] = self._t(pd)
                    entry["pt_dense"] = self._t(pd.T)
                else:
                    PT = P.T.tocsr()
                    PT.sort_indices()
                    for key, M, rows in (("p", P, n), ("pt", PT, pcols)):
                        src, mask, _ = _ell_map(rows,
                                                M.indptr.astype(np.int64))
                        entry[f"{key}_idx"] = self._t(
                            np.where(mask, M.indices[src], 0), torch.int64)
                        entry[f"{key}_val"] = self._t(
                            np.where(mask, M.data[src], 0.0))
            levels.append(entry)
        self._coarse_n = self._struct[-1]["n"]
        self.data = {"levels": levels}
        self._extract_values(L)

    def _plan_refresh(self) -> list[dict]:
        """The device refresh's plans, from the frozen structure: for each
        level its diagonal slots, the ELL map of its lambda_max estimate
        (and of its values, where it is 'ell'), the dense scatter where it
        is 'dense' or the coarsest, its power iteration's start vector, and
        above the coarsest the Galerkin products A P and P^T (A P) with the
        float64 values of P and P^T. Built with torch on the device."""
        from ..native import lib

        L, dev = lib(), self.device

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        x0 = t(galerkin.lcg_start(self._struct[0]["n"]), torch.float64)
        plan, patterns, nlev = [], [], len(self._struct)
        for l, st in enumerate(self._struct):
            n, rep, rowptr = st["n"], st["rep"], st["rowptr"]
            rp, ci = t(rowptr), t(st["colind"][:rowptr[-1]])
            patterns.append((rp, ci))
            rows = galerkin.rows_of(rp)
            on_diag = ci == rows
            diag = torch.zeros(n, dtype=torch.int64, device=dev)
            diag[rows[on_diag]] = torch.nonzero(on_diag).squeeze(1)
            has_diag = torch.zeros(n, dtype=torch.bool, device=dev)
            has_diag[rows[on_diag]] = True
            lp = {"diag": diag, "has_diag": has_diag}
            if rep in ("dense", "none"):
                lp["flat"] = rows * n + ci
            if rep != "none":
                src, mask, _ = _ell_map(n, rowptr)
                lp["ell_src"], lp["ell_mask"] = t(src, torch.int32), t(mask,
                                                                       bool)
                lp["ell_col"] = t(np.where(mask, st["colind"][src], 0),
                                  torch.int32)
                lp["x0"] = x0[:n]
            plan.append(lp)
        for l in range(nlev - 1):
            lp, n = plan[l], self._struct[l]["n"]
            nc = self._struct[l + 1]["n"]
            dims = np.zeros(4, np.int64)
            L.amg_level_dims(self.handle, l, dims)
            pnnz = int(dims[2])
            prow = np.zeros(n + 1, np.int64)
            pcol = np.zeros(max(pnnz, 1), np.int32)
            pval = np.zeros(max(pnnz, 1), np.float64)
            L.amg_get_prolongator(self.handle, l, prow, pcol, pval)
            p_rp, p_ci = t(prow), t(pcol[:pnnz])
            pt_rp, pt_ci, perm = galerkin.transpose(p_rp, p_ci, nc)
            lp["p"] = t(pval[:pnnz], torch.float64)
            lp["pt"] = lp["p"][perm]
            ap = lp["ap"] = galerkin.plan_product(*patterns[l], p_rp, p_ci,
                                                  nc)
            lp["ptap"] = galerkin.plan_product(pt_rp, pt_ci, ap.rowptr,
                                               ap.colind, nc, b_pos=ap.pos)
            rp, ci = patterns[l + 1]
            if not (torch.equal(lp["ptap"].rowptr, rp)
                    and torch.equal(lp["ptap"].colind, ci)):
                raise RuntimeError(
                    f"AMG level {l + 1}: the planned Galerkin pattern is not "
                    "the native hierarchy's")
        products = [lp[k] for lp in plan[:-1] for k in ("ap", "ptap")]
        work = torch.empty((3, max((p.block_terms for p in products),
                                   default=0)),
                           dtype=torch.float64, device=dev)
        for p in products:
            p.bind(work)
        return plan

    def refresh(self, values: torch.Tensor) -> list[torch.Tensor]:
        """The levels' values from the p = 1 values of the assembler the
        hierarchy was built on ((nnz,) float64 before its BC masks, on the
        device; `refreshes_from`), on the device, in float64 as
        csrc/amg.cpp's amg_refresh computes them: the masks, each level's
        Galerkin products in the native order (span pc/amg/galerkin, with
        the ELL and dense values), the diagonals and lambda_max of D^-1 A
        by the native power iteration (pc/amg/lam), and the coarse
        pseudo-inverse of _coarse_inv (pc/amg/coarse), each cast to the
        solve dtype at the end. The lambdas come to the host as floats
        with the coarse matrix's finiteness check, which synchronises once
        the values are done; the refresh ends synchronised. Counter
        amg.device_refreshes. Returns the levels' float64 CSR values, fine
        to coarse."""
        count("amg.device_refreshes")
        plan, dt = self._plan, self.dtype
        reps = [st["rep"] for st in self._struct]
        out = [{} for _ in plan]
        with span("pc/amg/galerkin"):
            vals = [self._source.masked(values)]
            for lp in plan[:-1]:
                ap = lp["ap"](vals[-1], lp["p"])
                c = lp["ptap"](lp["pt"], ap)
                vals.append(c.index_select(0, lp["ptap"].pos))
            ells = []
            for lp, v, rep, e in zip(plan, vals, reps, out):
                ell = None
                if rep != "none":
                    ell = torch.where(lp["ell_mask"], v.index_select(
                        0, lp["ell_src"].view(-1)).view(lp["ell_mask"].shape),
                        0.0)
                if rep == "ell":
                    e["a_val"] = ell.to(dt)
                elif rep == "dense":
                    n = lp["diag"].numel()
                    e["a_dense"] = v.new_zeros(n * n).index_copy_(
                        0, lp["flat"], v).view(n, n).to(dt)
                ells.append(ell)
        with span("pc/amg/lam"):
            lams = []
            for lp, v, ell, e in zip(plan[:-1], vals, ells, out):
                diag = torch.where(lp["has_diag"],
                                   v.index_select(0, lp["diag"]), 0.0)
                dinv = torch.where(diag != 0,
                                   1.0 / torch.where(diag == 0, 1.0, diag),
                                   1.0)
                e["dinv"] = dinv.to(dt)
                lams.append(galerkin.lambda_max(ell, lp["ell_col"], dinv,
                                                lp["x0"]))
        with span("pc/amg/coarse"):
            nc = self._coarse_n
            M = vals[-1].new_zeros(nc * nc).index_copy_(
                0, plan[-1]["flat"], vals[-1]).view(nc, nc)
            *lam, finite = torch.stack(
                lams + [torch.isfinite(M).all().double()]).tolist()
            if not finite:
                raise FloatingPointError(
                    "AMG coarse matrix has non-finite entries (check the "
                    "element matrices / stash feeding CSRAssembler)")
            coarse_inv = galerkin.sym_pinv(M).to(dt)
            sync(self.device)
        for e, lv, x in zip(out, self.data["levels"], lam):
            e["lam"] = x
            lv.update(e)
        self.data["coarse_inv"] = coarse_inv
        return vals

    def level_summary(self) -> list[tuple[int, str]]:
        """(n, representation) of each level, fine to coarse."""
        return [(st["n"], st["rep"]) for st in self._struct]

    # -- device-side application --------------------------------------------
    def apply(self, r_flat, data, top_matvec=None):
        """One V-cycle on a flat (3N,) node-major residual vector.

        top_matvec: flat (3N,) -> (3N,) level-0 operator action, required
        when the hierarchy was built with top_mf=True (the caller's
        matrix-free p = 1 apply, closed over the current Newton stash)."""
        sm = self.smooth_its
        levels = data["levels"]
        nlev = len(levels)

        def matvec(l, lv, x):
            if "a_dense" in lv:
                return lv["a_dense"] @ x
            if "a_val" in lv:
                return ell_matvec(lv["a_idx"], lv["a_val"], x)
            if l == 0 and top_matvec is not None:
                return top_matvec(x)
            raise ValueError(
                "AMG level 0 is matrix-free (top_mf=True) but no top_matvec "
                "was passed to apply()")

        def transfer_down(lv, r):
            if "pt_dense" in lv:
                return lv["pt_dense"] @ r
            return ell_matvec(lv["pt_idx"], lv["pt_val"], r)

        def transfer_up(lv, xc):
            if "p_dense" in lv:
                return lv["p_dense"] @ xc
            return ell_matvec(lv["p_idx"], lv["p_val"], xc)

        def smooth(l, lv, b, x=None):
            # Chebyshev on [0.1, 1.1] lam of D^-1 A (the p-MG smoother
            # bounds, elasticity.c:540)
            lam = lv["lam"]
            lo, hi = 0.1 * lam, 1.1 * lam
            theta = 0.5 * (hi + lo)
            delta = 0.5 * (hi - lo)
            sigma1 = theta / delta
            rho = 1.0 / sigma1
            # x = None is a zero initial guess: r = b without an A @ 0
            r = b if x is None else b - matvec(l, lv, x)
            d = (lv["dinv"] * r) / theta
            x = d if x is None else x + d
            for _ in range(sm - 1):
                r = b - matvec(l, lv, x)
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = (rho_new * rho * d
                     + (2.0 * rho_new / delta) * (lv["dinv"] * r))
                rho = rho_new
                x = x + d
            return x

        bs = [None] * nlev
        xs = [None] * nlev
        bs[0] = r_flat
        for l in range(nlev - 1):
            lv = levels[l]
            xs[l] = smooth(l, lv, bs[l])
            r = bs[l] - matvec(l, lv, xs[l])
            bs[l + 1] = transfer_down(lv, r)
        xs[nlev - 1] = data["coarse_inv"] @ bs[nlev - 1]
        for l in range(nlev - 2, -1, -1):
            lv = levels[l]
            x = xs[l] + transfer_up(lv, xs[l + 1])
            xs[l] = smooth(l, lv, bs[l], x)
        return xs[0]
