"""Model-level parity in float64: qdata, MMS forcing, the pointwise physics
of every model and the Jacobi diagonal (from the pointwise tangent) of the port against the JAX
package, at rtol 1e-12 (same algorithm, same data; only summation order
differs); the planes of linElas, hyperSS and hyperFSIncomp at 1e-13."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.mesh.fespace import build_fespace as jbuild
from ceedpetscsolid_tpu.models import Physics as JPhysics
from ceedpetscsolid_tpu.models import get_model as jget_model
from ceedpetscsolid_tpu.models import hyper_fs as jhfs
from ceedpetscsolid_tpu.models.base import Mat3 as JMat3
from ceedpetscsolid_tpu.models.forcing import assemble_forcing as jforcing
from ceedpetscsolid_tpu.ops.operator import OperatorFactory as JFactory
from ceedpetscsolid_tpu_torch import interop
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace as tbuild
from ceedpetscsolid_tpu_torch.models import get_model as tget_model
from ceedpetscsolid_tpu_torch.models import hyper_fs as thfs
from ceedpetscsolid_tpu_torch.models.base import Mat3 as TMat3
from ceedpetscsolid_tpu_torch.models.forcing import assemble_forcing as tforcing
from ceedpetscsolid_tpu_torch.ops.assembly import (diagonal_weights,
                                                   element_diagonal_of,
                                                   pointwise_tangent)
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory as TFactory
from test_torch_mesh import mesh_pair

RTOL = 1e-12
JPHYS = JPhysics(nu=0.3, E=1.0)
TPHYS = interop.physics_from_jax(JPHYS)


def factories(kind, n, degree):
    jm, tm = mesh_pair(kind, n)
    jf = JFactory([jbuild(jm, degree)], dtype=jnp.float64, use_pallas=False,
                  use_spectral=False)
    tf = TFactory(tbuild(tm, degree), dtype=torch.float64, device="cpu")
    return jf, tf


def close(a, b, rtol=RTOL, atol_rel=1e-14):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_rel * np.abs(b).max())


@pytest.mark.parametrize("kind,n,degree", [("box", 3, 2), ("scrambled", 3, 3)])
def test_qdata_and_mms_forcing(kind, n, degree):
    jf, tf = factories(kind, n, degree)
    jq = jf.compute_qdata()
    tq = tf.compute_qdata()
    close(tq.numpy(), jq)
    close(tf.quad_coords().numpy(), jf.quad_coords())
    jF = jforcing(jf, jq, "mms", phys=JPHYS)
    tF = tforcing(tf, tq, "mms", phys=TPHYS)
    close(tF.numpy(), jF)


def test_hyperfs_pointwise_physics():
    rng = np.random.default_rng(11)
    shape = (7, 27)
    du = rng.standard_normal((3, 3) + shape) * 0.1
    ddu = rng.standard_normal((3, 3) + shape)
    qd = rng.standard_normal((10,) + shape)
    qd[0] = np.abs(qd[0])
    jdv, jg = jhfs.residual_qf(jnp.asarray(du), jnp.asarray(qd), JPHYS)
    tdv, tg = thfs.residual_qf(torch.as_tensor(du), torch.as_tensor(qd), TPHYS)
    close(tdv.numpy(), jdv)
    for a, b in zip(tg.m, jg.m):
        close(a.numpy(), b)
    jjv = jhfs.jacobian_qf(jnp.asarray(ddu), jnp.asarray(qd), jg, JPHYS)
    tjv = thfs.jacobian_qf(torch.as_tensor(ddu), torch.as_tensor(qd), tg, TPHYS)
    close(tjv.numpy(), jjv)
    # energy across the shifted-series branches (1 + detC_m1 in
    # [0.35, 2.83]: below, inside and above sqrt(2)/2 .. sqrt(2))
    for scale in (0.02, 0.2, 0.4):
        d = rng.standard_normal((3, 3) + shape) * scale
        je = jhfs.energy_qf(jnp.asarray(d), jnp.asarray(qd), JPHYS)
        te = thfs.energy_qf(torch.as_tensor(d), torch.as_tensor(qd), TPHYS)
        close(te.numpy(), je)
    # Mat3 planes interop: JAX stash -> port stash tensor
    st = interop.stash_from_jax(JMat3(jg.m), *shape, device="cpu")
    np.testing.assert_array_equal(st.numpy(), np.stack(tg.m))
    assert isinstance(TMat3(st.unbind(0)), TMat3)


@pytest.mark.parametrize("kind,n,degree", [("box", 2, 3), ("scrambled", 2, 2)])
def test_jacobi_diagonal(kind, n, degree):
    jf, tf = factories(kind, n, degree)
    jq = jf.compute_qdata()
    rng = np.random.default_rng(5)
    N = jf.fine.space.num_nodes
    u = rng.standard_normal((3, N)) * 1e-2
    jres = jf.make_residual_structured(jhfs.residual_planes, JPHYS)
    _, jstash = jres(jnp.asarray(u), jq, jf.fine.srestr, jf.fine.sgrad)
    jdiag = jf.make_diagonal(jhfs.jacobian_qf, JPHYS)(
        jq, jf.stash_view(jstash), jf.fine.restr)
    tq = interop.qdata_from_jax(jq, tf.nelem, tf.Q3, device="cpu")
    tstash = interop.stash_from_jax(jstash, tf.nelem, tf.Q3,
                                    device="cpu")
    # the port's diagonal: the element diagonals of the pointwise tangent,
    # owner-summed
    tdiag = tf.restr.scatter_add(element_diagonal_of(
        pointwise_tangent(thfs.jacobian_qf, TPHYS, tq, tstash),
        diagonal_weights(tf.basis)))
    close(tdiag.numpy(), jdiag)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name,part", [
    ("linElas", ""), ("hyperSS", ""), ("hyperFSIncomp", ""),
    ("hyperFSIncomp", "pressure_")])
def test_model_planes_match_jax(name, part):
    """Residual planes and stash, Jacobian planes and energy density from
    the same seeded inputs (strains ~1e-2), port vs JAX, <= 1e-13 relative.
    linElas stashes nothing and its Jacobian ignores the stash."""
    jm, tm = jget_model(name), tget_model(name)
    rng = np.random.default_rng(17)
    shape = (5, 8)
    du = rng.standard_normal((3, 3) + shape) * 1e-2
    ddu = rng.standard_normal((3, 3) + shape)
    qd = rng.standard_normal((10,) + shape)
    qd[0] = np.abs(qd[0])
    jres, tres = getattr(jm, part + "residual_qf"), getattr(tm, part + "residual_qf")
    jjac, tjac = getattr(jm, part + "jacobian_qf"), getattr(tm, part + "jacobian_qf")
    jdv, jg = jres(jnp.asarray(du), jnp.asarray(qd), JPHYS)
    tdv, tg = tres(torch.as_tensor(du), torch.as_tensor(qd), TPHYS)
    assert _rel(tdv.numpy(), jdv) <= 1e-13
    assert (tg is None) == (jg is None) == (name == "linElas")
    if tg is not None:
        for a, b in zip(tg.m, jg.m):
            assert _rel(a.numpy(), b) <= 1e-13
    jjv = jjac(jnp.asarray(ddu), jnp.asarray(qd), jg, JPHYS)
    tjv = tjac(torch.as_tensor(ddu), torch.as_tensor(qd), tg, TPHYS)
    assert _rel(tjv.numpy(), jjv) <= 1e-13
    je = jm.energy_qf(jnp.asarray(du), jnp.asarray(qd), JPHYS)
    te = tm.energy_qf(torch.as_tensor(du), torch.as_tensor(qd), TPHYS)
    assert _rel(te.numpy(), je) <= 1e-13


def test_registry():
    """Every model of the reference's -problem enum is ported; an unknown
    name is refused naming the choices."""
    from ceedpetscsolid_tpu_torch.models import REGISTRY

    assert sorted(REGISTRY) == ["hyperFS", "hyperFSIncomp", "hyperSS",
                                "linElas"]
    for name, mod in REGISTRY.items():
        assert mod.name == name
    with pytest.raises(ValueError, match="linElas"):
        tget_model("neoHooke")
