"""The fused element apply (gather -> B -> physics -> B^T -> owner-sum).

CPU: the port's plain version against
  * the JAX XLA structured path in float64 at rtol 1e-12 (same data through
    interop, only summation order differs), for hyperFS and, parametrised,
    for linElas, hyperSS, hyperFSIncomp's mu part and its pressure part
    through the Q = 1 pressure factory;
  * the JAX Pallas kernel in interpret mode in float32 at the tolerances of
    tests/test_pallas_apply.py (rtol 2e-5, atol 1e-8; stash atol 1e-7), on
    the box and on the scrambled mesh (orientation-masked class rows).
The kernel itself is tested on the card by tests/test_torch_gpu.py, which
imports no JAX (the GPU machine has none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.mesh.fespace import build_fespace as jbuild
from ceedpetscsolid_tpu.models import Physics as JPhysics
from ceedpetscsolid_tpu.models import hyper_fs as jhfs
from ceedpetscsolid_tpu.ops.operator import OperatorFactory as JFactory
from ceedpetscsolid_tpu_torch import interop
from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace as tbuild
from ceedpetscsolid_tpu_torch.ops import fused_apply
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory as TFactory
from test_torch_mesh import mesh_pair

JPHYS = JPhysics(nu=0.3, E=1.0)
TPHYS = interop.physics_from_jax(JPHYS)


def _inputs(N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, N)) * 1e-3,
            rng.standard_normal((3, N)) * 1e-3)


def _port_apply(tf, qdata, u, v, stash_for_jac, physics="hyperFS"):
    res = tf.make_residual_structured(physics, TPHYS)
    jac = tf.make_jacobian_structured(physics, TPHYS)
    r, stash = res(u, qdata)
    return r, stash, jac(v, qdata, stash_for_jac)


@pytest.mark.parametrize("kind,n,degree", [
    ("box", 3, 2), ("box", 2, 4), ("scrambled", 3, 3), ("scrambled", 2, 4)])
def test_plain_matches_jax_xla_f64(kind, n, degree):
    jm, tm = mesh_pair(kind, n)
    jf = JFactory([jbuild(jm, degree)], dtype=jnp.float64, use_pallas=False,
                  use_spectral=False)
    tf = TFactory(tbuild(tm, degree), dtype=torch.float64, device="cpu")
    jq = jf.compute_qdata()
    u, v = _inputs(jf.fine.space.num_nodes, 3)
    jr, jst = jf.make_residual_structured(jhfs.residual_planes, JPHYS)(
        jnp.asarray(u), jq, jf.fine.srestr, jf.fine.sgrad)
    jjv = jf.make_jacobian_structured(jhfs.jacobian_planes, JPHYS)(
        jnp.asarray(v), jq, jst, jf.fine.srestr, jf.fine.sgrad)

    tq = interop.qdata_from_jax(jq, tf.nelem, tf.Q3, device="cpu")
    jst_t = interop.stash_from_jax(jst, tf.nelem, tf.Q3, device="cpu")
    tr, tst, tjv = _port_apply(tf, tq, interop.u_from_jax(u, device="cpu"),
                               interop.u_from_jax(v, device="cpu"), jst_t)
    for got, ref in ((tr, jr), (tst, jst_t), (tjv, jjv)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                   atol=1e-14 * np.abs(ref).max())


@pytest.mark.parametrize("physics", ["linElas", "hyperSS", "hyperFSIncomp",
                                     "hyperFSIncomp-pressure"])
@pytest.mark.parametrize("kind,n,degree", [("box", 3, 2), ("scrambled", 2, 3)])
def test_physics_plain_matches_jax_xla_f64(physics, kind, n, degree):
    """The other physics, residual L-vector, stash and J.v, port plain vs
    JAX XLA at rtol 1e-12; the pressure part through both packages' Q = 1
    factories (q1d=1). linElas has no stash in either."""
    from ceedpetscsolid_tpu_torch.models import get_model as tget_model

    jm, tm = mesh_pair(kind, n)
    pressure = physics.endswith("-pressure")
    q1d = 1 if pressure else None
    jf = JFactory([jbuild(jm, degree)], dtype=jnp.float64, use_pallas=False,
                  use_spectral=False, q1d=q1d)
    tf = TFactory(tbuild(tm, degree), dtype=torch.float64, device="cpu",
                  q1d=q1d)
    model = tget_model(physics.removesuffix("-pressure"))
    pre = "pressure_" if pressure else ""
    from ceedpetscsolid_tpu.models import get_model as jget_model

    jmod = jget_model(model.name)
    jq = jf.compute_qdata()
    u, v = _inputs(jf.fine.space.num_nodes, 5)
    u = u * 5                                   # strains ~1e-2
    jr, jst = jf.make_residual_structured(
        getattr(jmod, pre + "residual_planes"), JPHYS)(
        jnp.asarray(u), jq, jf.fine.srestr, jf.fine.sgrad)
    jjv = jf.make_jacobian_structured(
        getattr(jmod, pre + "jacobian_planes"), JPHYS)(
        jnp.asarray(v), jq, jst, jf.fine.srestr, jf.fine.sgrad)
    tq = interop.qdata_from_jax(jq, tf.nelem, tf.Q3, device="cpu")
    assert (jst is None) == (physics == "linElas")
    jst_t = None if jst is None else interop.stash_from_jax(
        jst, tf.nelem, tf.Q3, device="cpu")
    tr, tst, tjv = _port_apply(tf, tq, interop.u_from_jax(u, device="cpu"),
                               interop.u_from_jax(v, device="cpu"), jst_t,
                               physics)
    assert (tst is None) == (jst is None)
    pairs = [(tr, jr), (tjv, jjv)] + ([] if jst is None else [(tst, jst_t)])
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                   atol=1e-14 * np.abs(ref).max())


@pytest.mark.parametrize("kind,n,degree", [
    ("box", 3, 2), ("box", 3, 3), ("scrambled", 3, 2), ("scrambled", 3, 3)])
def test_plain_matches_jax_pallas_interpret_f32(kind, n, degree):
    jm, tm = mesh_pair(kind, n)
    fes = jbuild(jm, degree)
    plfac = JFactory([fes], dtype=jnp.float32, use_pallas=True,
                     pallas_interpret=True, block_elems=16)
    xfac = JFactory([fes], dtype=jnp.float32, use_pallas=False,
                    use_spectral=False)
    tf = TFactory(tbuild(tm, degree), dtype=torch.float32, device="cpu")
    qd = xfac.compute_qdata()
    qd_s = plfac.struct_qdata(qd)                  # lane/row padded
    u, v = _inputs(fes.num_nodes, 7)
    u32, v32 = jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32)
    r_pl, s_pl = plfac.make_residual_structured(jhfs.residual_planes, JPHYS)(
        u32, qd_s, plfac.fine.srestr, plfac.fine.sgrad)
    j_pl = plfac.make_jacobian_structured(jhfs.jacobian_planes, JPHYS)(
        v32, qd_s, s_pl, plfac.fine.srestr, plfac.fine.sgrad)

    f32 = torch.float32
    tq = interop.qdata_from_jax(qd_s, tf.nelem, tf.Q3, dtype=f32,
                                device="cpu")
    s_pl_t = interop.stash_from_jax(s_pl, tf.nelem, tf.Q3, dtype=f32,
                                    device="cpu")
    tr, tst, tjv = _port_apply(
        tf, tq, interop.u_from_jax(u32, dtype=f32, device="cpu"),
        interop.u_from_jax(v32, dtype=f32, device="cpu"), s_pl_t)
    np.testing.assert_allclose(tr.numpy(), np.asarray(r_pl),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(tst.numpy(), s_pl_t.numpy(),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(tjv.numpy(), np.asarray(j_pl),
                               rtol=2e-5, atol=1e-8)


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version, and launches no
    kernel."""
    _, tm = mesh_pair("box", 2)
    tf = TFactory(tbuild(tm, 2), dtype=torch.float64, device="cpu")
    q = tf.compute_qdata()
    u, v = (torch.as_tensor(a) for a in _inputs(tf.space.num_nodes, 1))
    before = (fused_apply.COUNTS.residual_launches,
              fused_apply.COUNTS.jacobian_launches)
    ve, st = fused_apply.residual(u, tf.restr.conn, q, tf.basis, TPHYS)
    ve0, st0 = fused_apply.residual_plain(u, tf.restr.conn, q, tf.basis, TPHYS)
    assert torch.equal(ve, ve0) and torch.equal(st, st0)
    jv = fused_apply.jacobian(v, tf.restr.conn, q, st, tf.basis, TPHYS)
    assert torch.equal(jv, fused_apply.jacobian_plain(
        v, tf.restr.conn, q, st, tf.basis, TPHYS))
    assert (fused_apply.COUNTS.residual_launches,
            fused_apply.COUNTS.jacobian_launches) == before


def test_kernel_input_checks():
    """The kernel wrapper's validation (device-independent) refuses what
    the CUDA kernel does not take."""
    _, tm = mesh_pair("box", 2)
    tf = TFactory(tbuild(tm, 2), dtype=torch.float64, device="cpu")
    q = tf.compute_qdata()
    u = torch.zeros((3, tf.space.num_nodes), dtype=torch.float64)
    st = torch.zeros((9, tf.nelem, tf.Q3), dtype=torch.float64)
    conn, b = tf.restr.conn, tf.basis
    fused_apply._check(u, conn, q, b, st)               # accepted
    with pytest.raises(TypeError):
        fused_apply._check(u.float(), conn, q, b, st)
    with pytest.raises(ValueError, match="shape"):
        fused_apply._check(u, conn, q[:, :-1], b, st)
    with pytest.raises(ValueError, match="contiguous"):
        fused_apply._check(u, conn, q.transpose(1, 2).contiguous().transpose(1, 2),
                           b, st)
    with pytest.raises(TypeError):
        fused_apply._check(u, conn.int(), q, b, st)
    # P < Q is instantiated: (3, 4), degree 2 at -qextra 1
    tf4 = TFactory(tbuild(tm, 2), qextra=1, dtype=torch.float64, device="cpu")
    fused_apply._check(u, tf4.restr.conn, tf4.compute_qdata(), tf4.basis,
                       torch.zeros((9, tf4.nelem, tf4.Q3), dtype=torch.float64))
    # (P, Q) = (3, 7), degree 2 at -qextra 4, has no template instance: the
    # generic tile takes it
    tf5 = TFactory(tbuild(tm, 2), qextra=4, dtype=torch.float64, device="cpu")
    assert fused_apply.is_generic("hyperFS", 3, 7)
    fused_apply._check(u, tf5.restr.conn, tf5.compute_qdata(), tf5.basis,
                       torch.zeros((9, tf5.nelem, tf5.Q3), dtype=torch.float64))
    # linElas takes no stash; the pressure term has template instances at
    # (P, 1) only, and the generic tile for (3, 3)
    fused_apply._check(u, conn, q, b, None, "linElas")
    with pytest.raises(ValueError, match="no stash"):
        fused_apply._check(u, conn, q, b, st, "linElas")
    with pytest.raises(ValueError, match="stash is missing"):
        fused_apply._check(u, conn, q, b, None, "hyperSS")
    assert fused_apply.is_generic("hyperFSIncomp-pressure", 3, 3)
    fused_apply._check(u, conn, q, b, st, "hyperFSIncomp-pressure")
    # a generic tile above what a block's shared memory holds is accepted:
    # (12, 12) in float64 runs the cluster body, at two CTAs or more
    tb = TFactory(tbuild(box_mesh((1, 1, 1)), 11), dtype=torch.float64,
                  device="cpu")
    fused_apply._check(torch.zeros((3, tb.space.num_nodes),
                                   dtype=torch.float64),
                       tb.restr.conn, tb.compute_qdata(), tb.basis,
                       torch.zeros((9, 1, 12 ** 3), dtype=torch.float64))
    assert fused_apply.launch_path(fused_apply.pointwise("hyperFS"), tb.basis,
                                   tb.compute_qdata()) == "generic_cluster"
    tp = TFactory(tbuild(tm, 2), dtype=torch.float64, device="cpu", q1d=1)
    fused_apply._check(u, tp.restr.conn, tp.compute_qdata(), tp.basis,
                       torch.zeros((9, tp.nelem, 1), dtype=torch.float64),
                       "hyperFSIncomp-pressure")
    with pytest.raises(ValueError, match="no physics"):
        fused_apply.pointwise("neoHooke")


@pytest.mark.parametrize("P,Q,dtype,nelem,body,elems,threads,smem", [
    # a warp a tile (Q <= 3): 4 ** 3 elements, fewer than 4 x 132 warps
    (2, 2, torch.float64, 64, "warp3x2", 1, 32, 3_168),
    # 24^3: 13,824 // 528 = 26, so E = 32 // 8 = 4
    (5, 2, torch.float32, 13_824, "warp6x2", 4, 32, 16_240),
    (7, 7, torch.float32, 1_728, "block8x8", 1, 192, 52_056),
    # above the register cap: the cluster body, one element a cluster of
    # 8 CTAs (one element leaves the SMs short of CTAs); bytes a CTA
    (10, 10, torch.float32, 1, "cluster", 1, 256, 16_000),
    (10, 10, torch.float64, 1, "cluster", 1, 256, 32_000),
    (11, 11, torch.float64, 1, "cluster", 1, 256, 38_720),
    (14, 14, torch.float32, 1, "cluster", 1, 256, 31_360),
    # phase 14's 8^3 levels and phase 15's 6^3 fine level: one element a
    # tile, a block each
    (5, 2, torch.float32, 512, "warp6x2", 1, 32, 4_516),
    (3, 2, torch.float32, 512, "warp3x2", 1, 32, 2_384),
    (2, 2, torch.float32, 512, "warp3x2", 1, 32, 1_776),
    (7, 7, torch.float32, 216, "block8x8", 1, 192, 52_056),
    # 12^3: 1,728 // 528 = 3 elements a tile; Q = 1 takes up to 32
    (5, 2, torch.float32, 1_728, "warp6x2", 3, 32, 12_332),
    (8, 1, torch.float32, 1_331, "warp8x3", 2, 32, 18_224),
    # a block tile of 343 // 132 = 2 elements at Q = 4: 128 points
    (3, 4, torch.float32, 343, "block8x8", 2, 128, 19_424),
])
def test_generic_plan_counted_by_hand(P, Q, dtype, nelem, body, elems,
                                      threads, smem):
    """The generic tile's plan for a J.v (19 staged planes) on the H100's
    132 SMs (csrc/fused_apply.cu generic_launch). Register bodies, in
    words: B, D as Q rows of PCV and B^T, D^T as P rows of QCV (the body's
    caps PC, QC rounded up to 16 bytes); per element buffer A max(3 P^2 PP,
    9 Q^2 PP, 9 P Q QQ) and buffer B max(6 P Q PP, 9 Q^3, 6 P^2 QQ),
    PP = P | 1, QQ = Q | 1; 19 planes of E Q^3 words rounded up to 16 bytes
    plus 16; 16 bytes of mbarrier. E.g. (5, 2) f32 (warp6x2: PCV = 8,
    QCV = 4): A = 375, B = 450, B/D 2 * 2 * 8 + 2 * 5 * 4 = 72; at 8^3
    E = 1 (512 // (4 * 132) = 0), a plane 8 + 4 words: 16 + 4 (72 + 19 * 12
    + 825) = 4,516 bytes, 512 one-warp blocks; at 24^3 E = 4, planes of
    32 + 4: 16 + 4 (72 + 19 * 36 + 4 * 825) = 16,240, 3,456 blocks.
    (7, 7) f32 (block8x8, PCV = QCV = 8): A = B = 9 * 49 * 7 = 3,087, B/D
    224, a plane 344 + 4: 16 + 4 (224 + 19 * 348 + 6,174) = 52,056; 343
    points in two passes of 172, rounded up to 192 threads. (3, 2) f32
    (warp3x2: PCV = QCV = 4): A = B = 162, B/D 40: 16 + 4 (40 + 228 + 324)
    = 2,384; (2, 2): A = 108, B = 72, B/D 32: 16 + 4 (32 + 228 + 180) =
    1,776, in f64 (PCV = 4, QCV = 2 doubles; planes of 8 + 2) 16 + 8 (24 +
    190 + 180) = 3,168. Above P, Q = 8 the cluster body: one element a
    cluster of k CTAs, each with B, D, B^T, D^T (4 Q P words), region A
    max(9 P ncc, 9 nzc Q^2) and region B max(3 nzc P^2 + 6 nzc P Q,
    9 Q ncc), nzc = ceil(P / k), ncc = ceil(Q^2 / k): (10, 10) f32 at
    k = 8, nzc = 2, ncc = 13: 4 (400 + 1,800 + 1,800) = 16,000 bytes;
    (11, 11) f64, nzc = 2, ncc = 16: 8 (484 + 2,178 + 2,178) = 38,720."""
    g = fused_apply.generic_plan(P, Q, dtype, nelem)
    assert (g.body, g.elems, g.threads, g.smem) == (body, elems, threads,
                                                    smem)
    cluster = body == "cluster"
    assert g.tiles == -(-nelem // elems) * (8 if cluster else 1)
    assert g.path == ("generic_cluster" if cluster else "generic")
    assert g.work == 0
    fused_apply.require_fits("hyperFS", P, Q)
    if not cluster:
        # a residual stages qdata's 10 planes alone
        stride = g.smem - fused_apply.generic_plan(P, Q, dtype, nelem,
                                                   planes=10).smem
        assert stride == 9 * (-(-elems * Q ** 3 * dtype.itemsize // 16) * 16
                              + 16)
    # on a card of one SM every warp-tile body takes its full tile: 32 //
    # Q^3 elements (one from Q = 3) within 64 KB; (5, 2) f32: 4
    assert fused_apply.generic_plan(5, 2, torch.float32, 13_824, sms=1) \
        .elems == 4


@pytest.mark.parametrize("P,Q,dtype,smem", [
    (12, 12, torch.float64, 251_136),
    (15, 15, torch.float32, 244_800),
    (21, 2, torch.float64, 265_272),     # P > Q: ue alone is 3 P^3 words
])
def test_gmem_above_a_block(P, Q, dtype, smem):
    """A generic tile whose one element needs more shared memory than an
    H100 block may have (232,448 bytes; `smem`: one block's bytes,
    2 Q P + max(3 P^3, 9 P Q^2) + max(6 P^2 Q, 9 Q^3) words) is accepted
    and planned on the cluster body at two CTAs or more; the gmem body,
    B and D alone in shared memory, takes only what no cluster of 8 CTAs
    holds (P = Q = 24 in this dtype, or 30 in f32); P and Q outside the
    generic tile's range are refused."""
    w = dtype.itemsize
    assert smem == w * (2 * Q * P + max(3 * P ** 3, 9 * P * Q * Q)
                        + max(6 * P * P * Q, 9 * Q ** 3))
    assert smem > fused_apply.H100_SMEM_PER_BLOCK
    fused_apply.require_fits("hyperFSIncomp-pressure", P, Q)
    fused_apply.require_fits("hyperFS", P, Q)
    g = fused_apply.generic_plan(P, Q, dtype, 1)
    assert (g.path, g.body, g.elems) == ("generic_cluster", "cluster", 1)
    assert fused_apply.cluster_fewest(P, Q, w) == 2
    big = 24 if w == 8 else 30
    g = fused_apply.generic_plan(big, big, dtype, 1)
    assert (g.path, g.body, g.elems, g.smem) == ("generic_gmem", "gmem", 1,
                                                 w * 2 * big * big)
    with pytest.raises(NotImplementedError, match="2 <= P <= 64"):
        fused_apply.require_fits("hyperFS", 65, Q)
    # a template instance is never the generic tile's
    assert not fused_apply.is_generic("hyperFS", 5, 6)
    assert not fused_apply.is_generic("hyperFSIncomp-pressure", 6, 1)
    assert fused_apply.is_generic("hyperFSIncomp-pressure", 7, 1)


def test_min_bytes_counted_by_hand():
    """The bound from shapes at 24^3, degree 4, float32 (13,824 elements,
    Q^3 = 125 points, 912,673 nodes): qdata 69.12 MB, stash 62.208 MB,
    u 10.952 MB, int64 conn 13.824 MB, ve 20.736 MB; 176.8 MB for hyperFS
    in either mode (J.v reads the stash, the residual writes it), 114.6 MB
    for linElas (no stash). Memory bounds both at 3.35 TB/s."""
    nelem, N = 24 ** 3, 97 ** 3
    f32 = torch.float32
    parts = 69_120_000 + 62_208_000 + 10_952_076 + 13_824_000 + 20_736_000
    for mode in ("residual", "jacobian"):
        assert fused_apply.min_bytes("hyperFS", mode, 5, 5, nelem, N,
                                     f32) == parts == 176_840_076
        assert fused_apply.min_bytes("linElas", mode, 5, 5, nelem, N,
                                     f32) == parts - 62_208_000
    assert fused_apply.min_bytes("hyperFS", "jacobian", 5, 5, nelem, N,
                                 torch.float64) == 2 * parts - 13_824_000
    ms, by = fused_apply.bound_ms("hyperFS", "jacobian", 5, 5, nelem, N, f32)
    assert by == "bytes" and ms == pytest.approx(0.052788, rel=1e-4)
    ms, by = fused_apply.bound_ms("linElas", "jacobian", 5, 5, nelem, N, f32)
    assert by == "bytes" and ms == pytest.approx(0.034218, rel=1e-4)
    with pytest.raises(ValueError, match="mode"):
        fused_apply.min_bytes("hyperFS", "energy", 5, 5, nelem, N, f32)


def test_min_flops_counted_by_hand():
    """Sum-factorized contractions at P = Q = 5: 30,000 FMAs an element
    (forward x 3,750, y 5,625, z 5,625; adjoint z 5,625, y 5,625, x 3,750),
    480 flops a point; plus the physics' own count a point. At 24^3 the
    hyperFS J.v needs 1.894 GFLOP, 28 us at 67 TFLOP/s: under the memory
    bound."""
    nelem = 24 ** 3
    for physics, (res, jac) in (("hyperFS", (362, 616)),
                                ("linElas", (140, 140))):
        assert fused_apply.min_flops(physics, "residual", 5, 5, 1) == \
            60_000 + 125 * res
        assert fused_apply.min_flops(physics, "jacobian", 5, 5, nelem) == \
            nelem * (60_000 + 125 * jac)
    # (P, Q) = (2, 5): forward 3*4*5*4 + 3*2*25*6 + 125*18 = 3,390 FMAs,
    # adjoint 125*18 + 3*4*5*15 + 3*8*10 = 3,390
    assert fused_apply.min_flops("hyperFS", "jacobian", 2, 5, 1) == \
        2 * 6_780 + 125 * 616
    # the pressure term, one point an element, (5, 1): forward x 750, y 225,
    # z 45; adjoint z 45, y 225, x 750 FMAs
    assert fused_apply.min_flops("hyperFSIncomp-pressure", "residual", 5, 1,
                                 1) == 2 * 2_040 + 299


@pytest.mark.parametrize("nelem,Q,dtype,shift,path", [
    (13_824, 5, torch.float32, False, "bulk"),  # 24^3: planes 16-byte multiples
    (27, 5, torch.float32, False, "async"),     # 13,500-byte planes
    (27, 4, torch.float32, False, "bulk"),      # 64 points: 256 bytes each
    (1, 5, torch.float32, False, "async"),
    (2, 5, torch.float64, False, "bulk"),       # 2,000-byte planes
    (27, 1, torch.float64, False, "async"),     # the pressure term's Q = 1
    (32, 1, torch.float32, False, "bulk"),
    (64, 5, torch.float32, True, "async"),      # base one word off 16 bytes
])
def test_copy_path(nelem, Q, dtype, shift, path):
    """TMA bulk copies only where every staged plane starts 16-byte aligned
    (its length and base); else cp.async. The residual stages qdata alone,
    J.v the stash too: a misaligned stash sends J.v to cp.async."""
    def planes(k):
        buf = torch.zeros(k * nelem * Q ** 3 + 1, dtype=dtype)
        return buf[int(shift):][:k * nelem * Q ** 3].view(k, nelem, Q ** 3)

    q, st = planes(10), planes(9)
    assert fused_apply.copy_path(q, None) == path
    assert fused_apply.copy_path(q, st) == path
    if path == "bulk":
        off = torch.zeros(9 * nelem * Q ** 3 + 1, dtype=dtype)[1:]
        assert fused_apply.copy_path(q, off.view(9, nelem, Q ** 3)) == "async"
