"""The port's CUDA kernel on the card (marked `gpu`; skipped without one).

Imports no JAX, so it runs on a GPU machine that has none: the port's CPU
float64 path, itself held against the JAX package by the other
tests/test_torch_*.py files, is the reference here. On the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(--noconftest: tests/conftest.py configures JAX, which is absent there.)
"""

import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh
from ceedpetscsolid_tpu_torch.models import Physics
from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
from ceedpetscsolid_tpu_torch.ops.basis import Basis3D
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory
from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem

pytestmark = pytest.mark.gpu
PHYS = Physics(nu=0.3, E=1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel runs only on a GPU")
    return torch.device("cuda")


def _case(kind, degree, device, seed=0):
    mesh = box_mesh((3, 3, 3)) if kind == "box" else scrambled_box_mesh(
        (3, 3, 3), seed=3)
    f = OperatorFactory(build_fespace(mesh, degree), dtype=torch.float64,
                        device=device)
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes)) * 1e-3,
                            device=device) for _ in range(2))
    return f, f.compute_qdata(), u, v


@pytest.mark.parametrize("kind", ["box", "scrambled"])
@pytest.mark.parametrize("degree", [2, 3, 4])
def test_kernel_matches_plain(cuda, kind, degree):
    """float64 kernel vs float64 plain to 1e-12 of max|ref| (only rounding
    order differs); float32 kernel vs float64 plain to rtol 2e-5 plus
    1e-6 max|ref| (float32 rounding alone reaches ~6e-7 max|ref|)."""
    f, q, u, v = _case(kind, degree, cuda, seed=degree)
    conn, b = f.restr.conn, f.basis
    ve0, st0 = fa.residual_plain(u, conn, q, b, PHYS)
    jv0 = fa.jacobian_plain(v, conn, q, st0, b, PHYS)
    ve, st = fa.residual(u, conn, q, b, PHYS)
    jv = fa.jacobian(v, conn, q, st0, b, PHYS)
    for got, ref in ((ve, ve0), (st, st0), (jv, jv0)):
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-12
    f32 = torch.float32
    b32 = Basis3D.create(b.P, b.Q, "gauss", f32, cuda)
    ve, st = fa.residual(u.to(f32), conn, q.to(f32), b32, PHYS)
    jv = fa.jacobian(v.to(f32), conn, q.to(f32), st0.to(f32), b32, PHYS)
    for got, ref in ((ve, ve0), (st, st0), (jv, jv0)):
        err = (got.double() - ref).abs()
        assert bool((err <= 2e-5 * ref.abs() + 1e-6 * ref.abs().max()).all())


def test_launch_counts_and_refusals(cuda):
    f, q, u, v = _case("box", 2, cuda)
    conn, b = f.restr.conn, f.basis
    fa.COUNTS.reset()
    _, st = fa.residual(u, conn, q, b, PHYS)
    fa.jacobian(v, conn, q, st, b, PHYS)
    fa.jacobian(v, conn, q, st, b, PHYS)
    torch.cuda.synchronize()
    assert (fa.COUNTS.residual_launches, fa.COUNTS.jacobian_launches) == (1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.jacobian(v, conn, q, st.transpose(1, 2).contiguous().transpose(1, 2),
                    b, PHYS)
    with pytest.raises(ValueError, match="on cpu"):
        fa.residual(u, conn, q.cpu(), b, PHYS)
    f2 = OperatorFactory(f.space, qextra=1, dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="qextra"):
        fa.residual(u, f2.restr.conn, f2.compute_qdata(), f2.basis, PHYS)
    assert (fa.COUNTS.residual_launches, fa.COUNTS.jacobian_launches) == (1, 2)
    with pytest.raises(NotImplementedError, match="qextra"):
        Config(problem="hyperFS", multigrid="none", qextra=1, device=cuda)


def test_solve_on_gpu_matches_cpu(cuda):
    """The whole slice on the card in float64 against the CPU float64 path
    (the JAX-checked one): same Newton count, KSP within 1, error and
    energy to 1e-8."""
    def run(device):
        cfg = Config(problem="hyperFS", degree=2, test_mode=True,
                     box_faces=(2, 2, 2), multigrid="none", num_increments=1,
                     device=device, dtype=torch.float64)
        p = ElasticityProblem(cfg)
        info = p.solve()
        return info, p.mms_error(info.u), p.strain_energy(info.u)

    fa.COUNTS.reset()
    ig, eg, wg = run(cuda)
    assert fa.COUNTS.residual_launches > 0 and fa.COUNTS.jacobian_launches > 0
    ic, ec, wc = run("cpu")
    assert ig.converged and ic.converged
    assert ig.snes_iters == ic.snes_iters
    assert abs(ig.ksp_iters - ic.ksp_iters) <= 1
    assert abs(eg - ec) <= 1e-8 * ec and abs(wg - wc) <= 1e-8 * wc
