"""The port's CUDA kernels on the card (marked `gpu`; skipped without one).

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
from ceedpetscsolid_tpu_torch.ops import gather_probe as gp
from ceedpetscsolid_tpu_torch.ops.basis import Basis3D
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory
from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem

pytestmark = pytest.mark.gpu
PHYS = Physics(nu=0.3, E=1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on a GPU")
    return torch.device("cuda")


def _case(kind, degree, device, seed=0, qextra=0):
    mesh = box_mesh((3, 3, 3)) if kind == "box" else scrambled_box_mesh(
        (3, 3, 3), seed=3)
    f = OperatorFactory(build_fespace(mesh, degree), qextra=qextra,
                        dtype=torch.float64, device=device)
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes)) * 1e-3,
                            device=device) for _ in range(2))
    return f, f.compute_qdata(), u, v


@pytest.mark.parametrize("kind", ["box", "scrambled"])
@pytest.mark.parametrize("degree,qextra", [(1, 0), (2, 0), (3, 0), (4, 0),
                                           (1, 3), (2, 2), (4, 1)])
def test_kernel_matches_plain(cuda, kind, degree, qextra):
    """float64 kernel vs float64 plain to 1e-12 of max|ref| (only rounding
    order differs); float32 kernel vs float64 plain to rtol 2e-5 plus
    1e-6 max|ref| (float32 rounding alone reaches ~6e-7 max|ref|). P = Q
    from 2 (the p = 1 level of p-MG) to 5, and the P < Q instances (2, 5),
    (3, 5), (5, 6): a coarse p-MG level at the fine level's rule, or a
    -qextra run."""
    f, q, u, v = _case(kind, degree, cuda, seed=degree, qextra=qextra)
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
    assert fa.COUNTS.by_pq == {("residual", 3, 3): 1, ("jacobian", 3, 3): 2}
    # (P, Q) = (3, 7) has no instance: degree 2 at -qextra 4
    f2 = OperatorFactory(f.space, qextra=4, dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="no instance for P=3, Q=7"):
        fa.residual(u, f2.restr.conn, f2.compute_qdata(), f2.basis, PHYS)
    assert (fa.COUNTS.residual_launches, fa.COUNTS.jacobian_launches) == (1, 2)
    with pytest.raises(NotImplementedError, match="-qextra 4"):
        Config(problem="hyperFS", degree=2, multigrid="none", qextra=4,
               device=cuda)


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


@pytest.mark.parametrize("shape", gp.CHECK_SHAPES)
def test_gather_probes_bitwise(cuda, shape):
    """Each probe kernel against its plain version, bitwise: the script's
    shape, a ragged one (partial row blocks and tiles), a narrow table, one
    that spans a cluster of 8 (512 KB) and one cut into column slabs."""
    tab, idx = gp.probe_inputs(cuda, seed=1, shape=shape)
    for name, fn in gp.PROBES.items():
        got = fn(tab, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, gp.PLAIN[name](tab, idx)), name
        assert torch.equal(got.cpu(), tab.cpu()[idx.cpu().long()]), name


@pytest.mark.parametrize("shape", [gp.PROBE_SHAPE, (100, 300, 36),
                                   (2000, 4096, 64), (4000, 512, 256)])
def test_gather_probe_index_semantics(cuda, shape):
    """Out-of-range indices (0, W-1, -1, -W, W, W+7, -W-1, the int32
    extremes and random ones in [-2W, 2W)): every kernel bitwise equal to
    its plain version on the card and on the CPU (the JAX-checked one):
    NaN rows for K3/K4, clamped rows for K5, zero rows for K6."""
    tab, idx = gp.probe_inputs(cuda, seed=2, shape=shape, out_of_range=True)
    for name, fn in gp.PROBES.items():
        got = fn(tab, idx)
        torch.cuda.synchronize()
        bits = got.view(torch.int32)
        assert torch.equal(bits, gp.PLAIN[name](tab, idx).view(torch.int32)), \
            name
        ref = gp.PLAIN[name](tab.cpu(), idx.cpu())
        assert torch.equal(bits.cpu(), ref.view(torch.int32)), name


def test_gather_probe_counts_and_refusals(cuda):
    tab, idx = gp.probe_inputs(cuda)
    gp.COUNTS.reset()
    gp.gather_loop(tab, idx)
    gp.gather_onehot(tab, idx)
    assert gp.COUNTS.launches == {"take": 0, "take_along_axis": 0,
                                  "loop": 1, "onehot": 1}
    gp.gather_take(tab, idx)
    gp.gather_take_along_axis(tab, idx)
    assert gp.COUNTS.cluster_dims == {"take": (8, 1, 1),
                                      "take_along_axis": (8, 1, 1)}
    with pytest.raises(TypeError, match="int32"):
        gp.gather_take(tab, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        gp.gather_loop(tab.t().contiguous().t(), idx)
    # 25,000 rows a block of a cluster of 8: 400 KB even at 4 columns
    big = torch.zeros((200_000, 4), device=cuda)
    with pytest.raises(ValueError, match="use gather_loop"):
        gp.gather_take(big, idx)
    with pytest.raises(ValueError, match="use gather_loop"):
        gp.gather_take_along_axis(torch.zeros((512, 30), device=cuda), idx)
    assert torch.equal(gp.gather_loop(big, idx), big[idx])
    assert gp.COUNTS.launches == {"take": 1, "take_along_axis": 1,
                                  "loop": 2, "onehot": 1}
    # odd width: the loop kernel's scalar path
    tab3 = torch.randn((50, 3), device=cuda)
    assert torch.equal(gp.gather_loop(tab3, idx % 50), tab3[idx % 50])


def test_pmg_solve_on_gpu_matches_cpu(cuda):
    """Degree-2 p-MG solve (levels [1, 2], native quadrature, Chebyshev
    coarse) on the card in float64 against the CPU float64 path: same
    Newton count, KSP within 1, error and energy to 1e-8. Both draw the
    same eigenvalue start vectors (numpy, seeded)."""
    def run(device):
        cfg = Config(problem="hyperFS", degree=2, test_mode=True,
                     box_faces=(2, 2, 2), multigrid="logarithmic",
                     coarse_solve="chebyshev", num_increments=1,
                     device=device, dtype=torch.float64)
        p = ElasticityProblem(cfg)
        info = p.solve()
        return info, p.mms_error(info.u), p.strain_energy(info.u)

    fa.COUNTS.reset()
    ig, eg, wg = run(cuda)
    assert {("jacobian", 2, 2), ("jacobian", 3, 3)} <= set(fa.COUNTS.by_pq)
    ic, ec, wc = run("cpu")
    assert ig.converged and ic.converged
    assert ig.snes_iters == ic.snes_iters
    assert abs(ig.ksp_iters - ic.ksp_iters) <= 1
    assert abs(eg - ec) <= 1e-8 * ec and abs(wg - wc) <= 1e-8 * wc
