"""The port's default device: CUDA unless the CPU is asked for.

`OperatorFactory`, the public builder of every operator, resolves its
device as `ElasticityProblem` does (device.select_device): without a CUDA
device and without `device="cpu"` it raises; with `device="cpu"` it
builds on the CPU, in float64 unless a dtype is given
(device.default_dtype, as `ElasticityProblem` chooses: float32 on CUDA),
and its residual matches the JAX package's factory in float64 at rtol
1e-12 (same data through interop, only summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.mesh.fespace import build_fespace as jbuild
from ceedpetscsolid_tpu.models import Physics as JPhysics
from ceedpetscsolid_tpu.models import hyper_fs as jhfs
from ceedpetscsolid_tpu.ops.operator import OperatorFactory as JFactory
from ceedpetscsolid_tpu_torch import interop, problem
from ceedpetscsolid_tpu_torch.device import default_dtype, select_device
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace as tbuild
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory as TFactory
from test_torch_mesh import mesh_pair

JPHYS = JPhysics(nu=0.3, E=1.0)
TPHYS = interop.physics_from_jax(JPHYS)


def test_problem_keeps_its_device_names():
    """problem.py still exports select_device and default_dtype (the
    device module's own functions)."""
    assert problem.select_device is select_device
    assert problem.default_dtype is default_dtype
    assert default_dtype(torch.device("cpu")) == torch.float64
    assert default_dtype(torch.device("cuda")) == torch.float32


def test_factory_raises_without_cuda_unless_cpu(monkeypatch):
    """No CUDA device and no device named: the factory raises the
    select_device error, as ElasticityProblem does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = mesh_pair("box", 2)
    space = tbuild(tm, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFactory(space)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFactory(space, dtype=torch.float64, q1d=1)
    f = TFactory(space, device="cpu")
    assert f.device == torch.device("cpu")
    assert f.restr.conn.device.type == "cpu"
    assert f.basis.B.device.type == "cpu"
    # no dtype given: default_dtype of the device, float64 on the CPU
    assert f.dtype == torch.float64
    assert f.basis.B.dtype == torch.float64
    assert f.compute_qdata().dtype == torch.float64
    assert TFactory(space, dtype=torch.float32,
                    device="cpu").basis.B.dtype == torch.float32


@pytest.mark.parametrize("kind,n,degree", [("box", 2, 2), ("scrambled", 2, 3)])
def test_cpu_factory_residual_matches_jax(monkeypatch, kind, n, degree):
    """Asked for the CPU, the factory's hyperFS residual and stash match the
    JAX package's factory in float64."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jm, tm = mesh_pair(kind, n)
    jf = JFactory([jbuild(jm, degree)], dtype=jnp.float64, use_pallas=False,
                  use_spectral=False)
    tf = TFactory(tbuild(tm, degree), dtype=torch.float64, device="cpu")
    jq = jf.compute_qdata()
    u = np.random.default_rng(5).standard_normal(
        (3, jf.fine.space.num_nodes)) * 1e-3
    jr, jst = jf.make_residual_structured(jhfs.residual_planes, JPHYS)(
        jnp.asarray(u), jq, jf.fine.srestr, jf.fine.sgrad)
    tq = tf.compute_qdata()
    np.testing.assert_allclose(
        tq.numpy(), np.asarray(interop.qdata_from_jax(jq, tf.nelem, tf.Q3,
                                                     device="cpu")),
        rtol=1e-12, atol=1e-14 * float(np.abs(np.asarray(jq)).max()))
    tr, tst = tf.make_residual_structured("hyperFS", TPHYS)(
        interop.u_from_jax(u, device="cpu"), tq)
    for got, ref in ((tr, np.asarray(jr)),
                     (tst, np.asarray(interop.stash_from_jax(
                         jst, tf.nelem, tf.Q3, device="cpu")))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                   atol=1e-14 * np.abs(ref).max())
