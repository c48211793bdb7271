"""The fused element apply (gather -> B -> hyperFS -> B^T -> owner-sum).

CPU: the port's plain version against
  * the JAX XLA structured path in float64 at rtol 1e-12 (same data through
    interop, only summation order differs);
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


def _port_apply(tf, qdata, u, v, stash_for_jac):
    res = tf.make_residual_structured(TPHYS)
    jac = tf.make_jacobian_structured(TPHYS)
    r, stash = res(u, qdata)
    return r, stash, jac(v, qdata, stash_for_jac)


@pytest.mark.parametrize("kind,n,degree", [
    ("box", 3, 2), ("box", 2, 4), ("scrambled", 3, 3), ("scrambled", 2, 4)])
def test_plain_matches_jax_xla_f64(kind, n, degree):
    jm, tm = mesh_pair(kind, n)
    jf = JFactory([jbuild(jm, degree)], dtype=jnp.float64, use_pallas=False,
                  use_spectral=False)
    tf = TFactory(tbuild(tm, degree), dtype=torch.float64)
    jq = jf.compute_qdata()
    u, v = _inputs(jf.fine.space.num_nodes, 3)
    jr, jst = jf.make_residual_structured(jhfs.residual_planes, JPHYS)(
        jnp.asarray(u), jq, jf.fine.srestr, jf.fine.sgrad)
    jjv = jf.make_jacobian_structured(jhfs.jacobian_planes, JPHYS)(
        jnp.asarray(v), jq, jst, jf.fine.srestr, jf.fine.sgrad)

    tq = interop.qdata_from_jax(jq, tf.nelem, tf.Q3)
    jst_t = interop.stash_from_jax(jst, tf.nelem, tf.Q3)
    tr, tst, tjv = _port_apply(tf, tq, interop.u_from_jax(u),
                               interop.u_from_jax(v), jst_t)
    for got, ref in ((tr, jr), (tst, jst_t), (tjv, jjv)):
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
    tf = TFactory(tbuild(tm, degree), dtype=torch.float32)
    qd = xfac.compute_qdata()
    qd_s = plfac.struct_qdata(qd)                  # lane/row padded
    u, v = _inputs(fes.num_nodes, 7)
    u32, v32 = jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32)
    r_pl, s_pl = plfac.make_residual_structured(jhfs.residual_planes, JPHYS)(
        u32, qd_s, plfac.fine.srestr, plfac.fine.sgrad)
    j_pl = plfac.make_jacobian_structured(jhfs.jacobian_planes, JPHYS)(
        v32, qd_s, s_pl, plfac.fine.srestr, plfac.fine.sgrad)

    f32 = torch.float32
    tq = interop.qdata_from_jax(qd_s, tf.nelem, tf.Q3, dtype=f32)
    s_pl_t = interop.stash_from_jax(s_pl, tf.nelem, tf.Q3, dtype=f32)
    tr, tst, tjv = _port_apply(tf, tq, interop.u_from_jax(u32, dtype=f32),
                               interop.u_from_jax(v32, dtype=f32), s_pl_t)
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
    tf = TFactory(tbuild(tm, 2), dtype=torch.float64)
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
    tf = TFactory(tbuild(tm, 2), dtype=torch.float64)
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
    tf4 = TFactory(tbuild(tm, 2), qextra=1, dtype=torch.float64)
    fused_apply._check(u, tf4.restr.conn, tf4.compute_qdata(), tf4.basis,
                       torch.zeros((9, tf4.nelem, tf4.Q3), dtype=torch.float64))
    # (P, Q) = (3, 7), degree 2 at -qextra 4, has no instance
    tf5 = TFactory(tbuild(tm, 2), qextra=4, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="no instance for P=3, Q=7"):
        fused_apply._check(u, tf5.restr.conn, tf5.compute_qdata(), tf5.basis,
                           torch.zeros((9, tf5.nelem, tf5.Q3),
                                       dtype=torch.float64))
