"""The generic tile's cluster body (csrc/fused_apply.cu
generic_cluster_kernel): one element a thread-block cluster of k CTAs.

CPU, no card:
  * the plan mirror (ops/fused_apply.py generic_body, generic_plan,
    cluster_plan, cluster_size) over P = 2..24,
    Q = 1..24 in both dtypes: the body is "cluster" exactly above the
    register bodies' cap where a cluster of at most 8 CTAs holds an
    element, k is the fewest CTAs whose share fits 232,448 bytes or the
    rule's larger k (doubled while two CTAs could not share an SM's
    shared memory or the grid has fewer CTAs than SMs), every CTA's share
    fits, every pz-slab and every (qy, qx) column has one owner, and
    "gmem" is chosen only beyond 8 CTAs;
  * a plain-torch emulation of the kernel's decomposition, with the
    kernel's own index arithmetic: per CTA its slab phases (gather,
    forward x and y), forward y's stores into the column owners' region A
    as index copies, its column phases (forward z, the physics, adjoint
    z), adjoint z's stores into the slab owners' region A, then adjoint y
    and x; each CTA's regions A and B are tensors of the plan's sizes,
    filled with NaN, so a read of an unwritten word or a store past a
    region shows. It is held against residual_plain / jacobian_plain in
    float64 to 1e-13 of max|ref| at k = 1..8.
The kernel itself runs only on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 3d).
"""

import functools

import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
from ceedpetscsolid_tpu_torch.models import Physics
from ceedpetscsolid_tpu_torch.models.base import Mat3
from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory

PHYS = Physics(nu=0.3, E=1.0)
LIMIT = 232_448                      # an H100 block's opt-in shared memory


def owners(n, k):
    """What each of k CTAs owns of n pz-slabs (n = P) or (qy, qx) columns
    (n = Q^2), as the kernel splits them: CTA r the range
    [r c, min(n, r c + c)), c = ceil(n / k)."""
    c = -(-n // k)
    return [range(min(n, r * c), min(n, r * c + c)) for r in range(k)]


def _share(P, Q, w, k):
    """A CTA's bytes, written out: B, D, B^T, D^T; region A (the columns'
    t2, then the slabs' adjoint t2); region B (the slabs' ue and t1, then
    the columns' dv, then the slabs' adjoint t1)."""
    nzc, ncc = -(-P // k), -(-Q * Q // k)
    a = max(9 * P * ncc, 9 * nzc * Q * Q)
    b = max(3 * nzc * P * P + 6 * nzc * P * Q, 9 * Q * ncc, 6 * nzc * P * Q)
    return w * (4 * Q * P + a + b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_mirror_takes_cluster_exactly_where_a_cluster_holds(dtype):
    w = dtype.itemsize
    sms = fa.H100_SMS
    for P in range(2, 25):
        for Q in range(1, 25):
            fits = [k for k in range(1, 9) if _share(P, Q, w, k) <= LIMIT]
            high = max(P, Q) > fa.GENERIC_REG_CAP
            body = fa.GENERIC_BODIES[fa.generic_body(P, Q, dtype)]
            if not high:
                assert body not in ("cluster", "gmem", "smem"), (P, Q)
                continue
            assert body == ("cluster" if fits else "gmem"), (P, Q, dtype)
            if not fits:
                assert _share(P, Q, w, 8) > LIMIT
                assert fa.generic_plan(P, Q, dtype, 216).path == \
                    "generic_gmem"
                continue
            fewest = fits[0]
            assert fa.cluster_fewest(P, Q, w) == fewest
            for nelem in (1, 125, 216, 343, 1000, 13824):
                g = fa.generic_plan(P, Q, dtype, nelem, sms)
                k = g.cluster
                # the rule: double the fewest, within 8, while a CTA's share
                # leaves no room for a second on its SM (228 KB less 1 KB
                # a CTA) or the grid has fewer CTAs than the card has SMs
                want = fewest
                while 2 * want <= 8 and (
                        _share(P, Q, w, want) > (233_472 - 2048) // 2
                        or nelem * want < sms):
                    want *= 2
                assert k == want, (P, Q, nelem, k, want)
                assert (g.path, g.body, g.elems, g.threads, g.tiles,
                        g.clusters, g.work) == (
                    "generic_cluster", "cluster", 1, 256, nelem * k,
                    nelem, 0)
                assert g.smem == _share(P, Q, w, k) <= LIMIT
                # every slab and every column has exactly one owner
                for n in (P, Q * Q):
                    split = owners(n, k)
                    assert len(split) == k
                    seen = [i for rg in split for i in rg]
                    assert seen == list(range(n))
            # the override takes any size that fits
            for k in range(fewest, 9):
                g = fa.generic_plan(P, Q, dtype, 125, sms, cluster=k)
                assert g.cluster == k and g.smem <= LIMIT
    # the shapes that matter: (P, Q, dtype) -> the fewest CTAs
    for P, Q, dt, k in ((9, 9, torch.float32, 1), (9, 9, torch.float64, 1),
                        (12, 12, torch.float64, 2),
                        (15, 15, torch.float32, 2),
                        (21, 2, torch.float64, 2),
                        (20, 20, torch.float64, 7)):
        if dt == dtype:
            assert fa.cluster_fewest(P, Q, w) == k, (P, Q)


@functools.lru_cache(maxsize=None)
def _case(physics, P, Q, faces):
    """Inputs on the CPU in float64, seeded with numpy: factory, qdata, u,
    v; amplitude divided by (P / 5)^2 so that gradu stays ~1e-2."""
    f = OperatorFactory(build_fespace(box_mesh(faces), P - 1),
                        dtype=torch.float64, device="cpu", q1d=Q)
    rng = np.random.default_rng(P * 100 + Q)
    amp = 5e-3 * (5 / P) ** 2
    u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes))
                            * amp) for _ in range(2))
    return f, f.compute_qdata(), u, v


def emulate(jacobian, x, conn, qdata, stash, basis, pw, k):
    """The cluster kernel's decomposition at k CTAs an element, phase by
    phase, with its index arithmetic: (ve, stash out or None)."""
    P, Q = basis.P, basis.Q
    P2, P3, Q2, Q3 = P * P, P ** 3, Q * Q, Q ** 3
    B, D = basis.B, basis.D              # (Q, P)
    nelem = conn.shape[0]
    cp = fa.cluster_plan(P, Q, 8, k)
    nzc, ncc = cp.nzc, cp.ncc
    T1S, T2S, A2S, DVS = 3 * nzc * P * Q, 3 * P * ncc, 3 * nzc * Q2, Q * ncc
    t1 = 3 * nzc * P2
    slabs, cols = owners(P, k), owners(Q2, k)
    ve = torch.full((3, nelem, P3), float("nan"), dtype=torch.float64)
    st_out = (torch.full((9, nelem, Q3), float("nan"), dtype=torch.float64)
              if pw.stash and not jacobian else None)
    ar = torch.arange
    for e in range(nelem):
        RA = [torch.full((cp.a_words,), float("nan"), dtype=torch.float64)
              for _ in range(k)]
        RB = [torch.full((cp.b_words,), float("nan"), dtype=torch.float64)
              for _ in range(k)]
        # ---- slab phases: gather, forward x, forward y -> column owners
        for r in range(k):
            z0, nz = r * nzc, len(slabs[r])
            assert nz == 0 or slabs[r].start == z0
            i = ar(nz * P2)
            node = conn[e, z0 * P2 + i]
            for c in range(3):
                RB[r][c * nzc * P2 + i] = x[c, node]
            i = ar(3 * nz * P * Q)
            qx, rr = i % Q, i // Q
            py, r2 = rr % P, rr // P
            zl, c = r2 % max(nz, 1), r2 // max(nz, 1)
            row = (c * nzc + zl) * P + py
            xs = RB[r][row[:, None] * P + ar(P)[None, :]]
            RB[r][t1 + row * Q + qx] = (B[qx] * xs).sum(1)    # B^T[px][qx]
            RB[r][t1 + T1S + row * Q + qx] = (D[qx] * xs).sum(1)
            i = ar(3 * nz * Q2)
            col, r2 = i % Q2, i // Q2
            zl, c = r2 % max(nz, 1), r2 // max(nz, 1)
            qy, qx = col // Q, col % Q
            base = t1 + (c * nzc + zl) * P * Q + qx
            x0 = RB[r][base[:, None] + ar(P)[None, :] * Q]
            x1 = RB[r][base[:, None] + T1S + ar(P)[None, :] * Q]
            vals = ((B[qy] * x1).sum(1), (D[qy] * x0).sum(1),
                    (B[qy] * x0).sum(1))
            o, lc = col // ncc, col % ncc
            dst = (c * P + z0 + zl) * ncc + lc
            for owner in range(k):
                m = o == owner
                for j, val in enumerate(vals):
                    RA[owner][j * T2S + dst[m]] = val[m]
        # ---- column phases: forward z, the physics, adjoint z -> slabs
        dvs = []
        for r in range(k):
            c0, nc = r * ncc, len(cols[r])
            assert nc == 0 or cols[r].start == c0
            i = ar(Q * nc)
            qz, lc = i // max(nc, 1), i % max(nc, 1)
            off = qz * Q2 + c0 + lc
            du = torch.empty((3, 3, 1, Q * nc), dtype=torch.float64)
            for c in range(3):
                rows = c * P * ncc + lc[:, None] + ar(P)[None, :] * ncc
                du[c, 0, 0] = (B[qz] * RA[r][rows]).sum(1)
                du[c, 1, 0] = (B[qz] * RA[r][T2S + rows]).sum(1)
                du[c, 2, 0] = (D[qz] * RA[r][2 * T2S + rows]).sum(1)
            q = qdata[:, e:e + 1, off]
            if jacobian:
                st = None if stash is None else Mat3(
                    stash[:, e:e + 1, off].unbind(0))
                dv = pw.jacobian_planes(Mat3.from_array(du), q, st, PHYS)
            else:
                dv, g = pw.residual_planes(Mat3.from_array(du), q, PHYS)
                if st_out is not None:
                    st_out[:, e, off] = torch.stack(g.m)[:, 0]
            dv = dv.to_array().reshape(9, Q * nc)
            for m in range(9):
                RB[r][m * DVS + qz * ncc + lc] = dv[m]
            dvs.append(nc)
        for r in range(k):
            c0, nc = r * ncc, dvs[r]
            i = ar(3 * P * nc)
            lc, rr = i % max(nc, 1), i // max(nc, 1)
            pz, c = rr % P, rr // P
            qzs = ar(Q)[None, :] * ncc
            d = 3 * c * DVS + lc
            bt, dt = B[:, pz].T, D[:, pz].T            # (n, Q)
            vals = ((bt * RB[r][d[:, None] + qzs]).sum(1),
                    (bt * RB[r][DVS + d[:, None] + qzs]).sum(1),
                    (dt * RB[r][2 * DVS + d[:, None] + qzs]).sum(1))
            s, zl = pz // nzc, pz % nzc
            dst = (c * nzc + zl) * Q2 + c0 + lc
            for owner in range(k):
                m = s == owner
                for j, val in enumerate(vals):
                    RA[owner][j * A2S + dst[m]] = val[m]
        # ---- slab phases: adjoint y, adjoint x -> ve
        for r in range(k):
            z0, nz = r * nzc, len(slabs[r])
            i = ar(3 * nz * P * Q)
            qx, rr = i % Q, i // Q
            py, r2 = rr % P, rr // P
            zl, c = r2 % max(nz, 1), r2 // max(nz, 1)
            y = (c * nzc + zl) * Q2 + qx
            qys = ar(Q)[None, :] * Q
            bt, dt = B[:, py].T, D[:, py].T
            o = ((c * nzc + zl) * P + py) * Q + qx
            RB[r][o] = (bt * RA[r][y[:, None] + qys]).sum(1)
            RB[r][T1S + o] = (dt * RA[r][A2S + y[:, None] + qys]).sum(1) + (
                bt * RA[r][2 * A2S + y[:, None] + qys]).sum(1)
            i = ar(3 * nz * P2)
            px, rr = i % P, i // P
            py, r2 = rr % P, rr // P
            zl, c = r2 % max(nz, 1), r2 // max(nz, 1)
            x0 = ((c * nzc + zl) * P + py) * Q
            qxs = ar(Q)[None, :]
            acc = (D[:, px].T * RB[r][x0[:, None] + qxs]).sum(1) + (
                B[:, px].T * RB[r][T1S + x0[:, None] + qxs]).sum(1)
            ve[c, e, (z0 + zl) * P2 + py * P + px] = acc
    return ve, st_out


# (physics, P, Q, box faces): hyperFS at phase 19's shapes and its (9, 9)
# level, linElas (no stash), the pressure term's (21, 2), and a ragged
# shape where most k divide neither P = 11 nor Q^2 = 100
CASES = (("hyperFS", 9, 9, (2, 1, 1)),
         ("hyperFS", 12, 12, (1, 1, 1)),
         ("hyperFS", 15, 15, (1, 1, 1)),
         ("linElas", 12, 12, (1, 1, 1)),
         ("hyperFSIncomp-pressure", 21, 2, (1, 1, 1)),
         ("hyperSS", 11, 10, (2, 1, 1)))


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("physics,P,Q,faces", CASES)
def test_decomposition_matches_plain(physics, P, Q, faces, k):
    f, q, u, v = _case(physics, P, Q, faces)
    pw = fa.pointwise(physics)
    conn, b = f.restr.conn, f.basis
    assert (b.P, b.Q) == (P, Q)
    ve0, st0 = fa.residual_plain(u, conn, q, b, PHYS, pw)
    jv0 = fa.jacobian_plain(v, conn, q, st0, b, PHYS, pw)
    ve, st = emulate(False, u, conn, q, None, b, pw, k)
    jv, _ = emulate(True, v, conn, q, st0, b, pw, k)
    pairs = [(ve, ve0), (jv, jv0)] + ([(st, st0)] if pw.stash else [])
    assert (st is None) == (st0 is None)
    for got, ref in pairs:
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-13, (physics, P, Q, k, err)
