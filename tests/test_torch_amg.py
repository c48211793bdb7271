"""The port's assembled p = 1 matrix and AMG against the JAX package
(float64, CPU), and the port analogs of tests/test_amg.py.

Both packages run the same native setup (csrc/amg.cpp; the port builds its
own copy into build/native/), so the same CSR gives the same hierarchy:
the tests hand the port JAX's CSR through interop.csr_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.mesh.fespace import build_fespace as jbuild
from ceedpetscsolid_tpu.models import Physics as JPhysics
from ceedpetscsolid_tpu.models import get_model as jget_model
from ceedpetscsolid_tpu.ops.assembly import CSRAssembler as JAssembler
from ceedpetscsolid_tpu.ops.assembly import make_element_matrices as jem
from ceedpetscsolid_tpu.ops.operator import OperatorFactory as JFactory
from ceedpetscsolid_tpu.solve.amg import AMGPreconditioner as JAMG
from ceedpetscsolid_tpu_torch import interop
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace as tbuild
from ceedpetscsolid_tpu_torch.models import get_model as tget_model
from ceedpetscsolid_tpu_torch.ops.assembly import CSRAssembler, make_element_matrices
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory as TFactory
from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem
from ceedpetscsolid_tpu_torch.solve.amg import AMGPreconditioner
from ceedpetscsolid_tpu_torch.solve.cg import pcg
from amg_refresh_pair import check_device_refresh
from test_torch_mesh import mesh_pair

JPHYS = JPhysics(nu=0.3, E=1.0)
TPHYS = interop.physics_from_jax(JPHYS)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _p1_pair(name, kind, n, seed=3):
    """JAX and port element matrices of one model on a degree-1 mesh, from
    the same state (strains ~1e-2), and both assemblers' CSR."""
    jm, tm = mesh_pair(kind, n)
    jf = JFactory([jbuild(jm, 1)], dtype=jnp.float64, use_pallas=False,
                  use_spectral=False)
    tf = TFactory(tbuild(tm, 1), dtype=torch.float64, device="cpu")
    jmod, tmod = jget_model(name), tget_model(name)
    jq = jf.compute_qdata()
    u = np.random.default_rng(seed).standard_normal(
        (3, tf.space.num_nodes)) * 1e-2 / n
    _, jst = jf.make_residual_structured(jmod.residual_planes, JPHYS)(
        jnp.asarray(u), jq, jf.fine.srestr, jf.fine.sgrad)
    jst = None if jst is None else jf.stash_view(jst)
    jA = np.asarray(jax.jit(lambda q, s: jem(
        jmod.jacobian_qf, JPHYS, jf.fine.basis, jnp.float64)(q, s))(jq, jst))
    tq = interop.qdata_from_jax(jq, tf.nelem, tf.Q3, device="cpu")
    tst = None if jst is None else interop.stash_from_jax(
        jst, tf.nelem, tf.Q3, device="cpu")
    tA = make_element_matrices(tmod.jacobian_qf, TPHYS, tf.basis,
                               torch.float64)(tq, tst)
    s = tf.space
    mask = np.zeros((3, s.num_nodes), bool)
    mask[:, s.all_boundary_nodes()] = True
    return (jA, JAssembler(s.conn, s.num_nodes, mask),
            tA, CSRAssembler(s.conn, s.num_nodes, mask, device="cpu"))


@pytest.mark.parametrize("name,kind", [("linElas", "box"),
                                       ("hyperSS", "scrambled"),
                                       ("hyperFS", "box")])
def test_element_matrices_and_csr_match_jax(name, kind):
    """Element matrices <= 1e-13 relative; the CSR patterns equal; the
    port's fixed-order device slot reduction vs JAX's bincount <= 1e-13."""
    jA, jasm, tA, tasm = _p1_pair(name, kind, 3)
    assert _rel(tA.numpy(), jA) <= 1e-13
    jcsr, tcsr = jasm.assemble(jA), tasm.assemble(tA)
    np.testing.assert_array_equal(tcsr.indptr, jcsr.indptr)
    np.testing.assert_array_equal(tcsr.indices, jcsr.indices)
    assert _rel(tcsr.data, jcsr.data) <= 1e-13
    # the same reduction twice: the same bits
    assert torch.equal(tasm.assemble_values(tA), tasm.assemble_values(tA))


@pytest.fixture(scope="module")
def jax_csr():
    """JAX's assembled linElas p = 1 matrix on 8^3 (2,187 DOFs: more than
    the AMG's coarse size, so the hierarchy has several levels)."""
    jA, jasm, _, _ = _p1_pair("linElas", "box", 8)
    return jasm.assemble(jA)


@pytest.mark.parametrize("top_mf,dense_n", [(True, 4096), (False, 0)])
def test_amg_from_jax_csr_matches_jax(jax_csr, top_mf, dense_n):
    """The same CSR through interop: the same level sizes, and one V-cycle
    <= 1e-12 relative to JAX's apply, with a matrix-free level 0 and dense
    small levels, and with pure ELL levels."""
    A = jax_csr
    jamg = JAMG(jnp.float64, top_mf=top_mf, dense_n=dense_n)
    jamg.setup(A)
    tamg = AMGPreconditioner(torch.float64, "cpu", top_mf=top_mf,
                             dense_n=dense_n)
    tamg.setup(interop.csr_from_jax(A.indptr, A.indices, A.data, A.shape[0]))
    sizes = [st["n"] for st in jamg._struct]
    assert [n for n, _ in tamg.level_summary()] == sizes
    assert len(sizes) >= 2
    reps = [rep for _, rep in tamg.level_summary()]
    assert reps[0] == ("mf" if top_mf else "ell") and reps[-1] == "none"
    r = np.random.default_rng(1).standard_normal(A.shape[0])
    jx = jamg.apply(jnp.asarray(r), jamg.data,
                    top_matvec=lambda x: jnp.asarray(A @ np.asarray(x)))
    tx = tamg.apply(torch.as_tensor(r), tamg.data,
                    top_matvec=lambda x: torch.as_tensor(A @ x.numpy()))
    assert _rel(tx.numpy(), jx) <= 1e-12


def test_amg_representations_agree(jax_csr):
    """Matrix-free level 0 + dense small levels vs pure ELL: the same
    preconditioner to 1e-12 (tests/test_amg.py's check, on the port)."""
    A = jax_csr
    Ac = interop.csr_from_jax(A.indptr, A.indices, A.data, A.shape[0])
    ell = AMGPreconditioner(torch.float64, "cpu", dense_n=0)
    ell.setup(Ac)
    fast = AMGPreconditioner(torch.float64, "cpu", top_mf=True)
    fast.setup(Ac)
    assert any("a_dense" in lv or "p_dense" in lv for lv in fast.data["levels"])
    assert "a_val" not in fast.data["levels"][0]
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(A.shape[0]))
    x_ell = ell.apply(r, ell.data)
    x_fast = fast.apply(r, fast.data,
                        top_matvec=lambda x: torch.as_tensor(A @ x.numpy()))
    assert float(torch.linalg.norm(x_fast - x_ell)
                 / torch.linalg.norm(x_ell)) < 1e-12


def _linelas_p1(n, multigrid="none", **kw):
    return ElasticityProblem(Config(problem="linElas", degree=1, nu=0.3, E=1.0,
                                    test_mode=True, box_faces=(n, n, n),
                                    multigrid=multigrid, device="cpu", **kw))


def _assembled(prob):
    s0 = prob.spaces[0]
    asm = CSRAssembler(s0.conn, s0.num_nodes, prob.bc_mask.numpy(),
                       device="cpu")
    em = make_element_matrices(prob.model.jacobian_qf, prob.phys,
                               prob.factory.levels[0].basis, prob.dtype)
    return asm.assemble(em(prob.qdata, None))


def test_assembled_matches_matrix_free():
    """The assembled p = 1 matrix is the matrix-free operator (<= 1e-13)."""
    prob = _linelas_p1(4)
    A = _assembled(prob)
    mask = prob.bc_mask.numpy()
    v = np.where(mask, 0.0, np.random.default_rng(0).normal(size=mask.shape))
    Av = np.where(mask, 0.0, (A @ v.T.reshape(-1)).reshape(-1, 3).T)
    Jv = prob._jacobian_action(torch.as_tensor(v), None).numpy()
    assert np.abs(Av - Jv).max() / np.abs(Jv).max() < 1e-13


def test_amg_reduces_cg_iterations():
    """One AMG V-cycle as CG's preconditioner at least halves the
    iterations of plain CG, to the same answer (1e-12)."""
    prob = _linelas_p1(8)
    amg = AMGPreconditioner(prob.dtype, "cpu")
    amg.setup(_assembled(prob))
    G, stash = prob._nonlinear_residual(
        torch.zeros((3, prob.fine_space.num_nodes), dtype=torch.float64),
        prob.bc_values(1.0), prob.F)

    def Aop(x):
        return prob._jacobian_action(x, stash)

    def M(r):
        return amg.apply(r.T.reshape(-1), amg.data).reshape(-1, 3).T

    plain = pcg(Aop, -G, rtol=1e-10)
    pre = pcg(Aop, -G, M_inv=M, rtol=1e-10)
    assert pre.iters < plain.iters // 2
    assert float((pre.x - plain.x).abs().max()) < 1e-12


def test_amg_refresh_keeps_pattern_and_quality(monkeypatch):
    """hyperSS clamp solve, p-MG + AMG coarse: the hierarchy's structure is
    extracted once and its values refreshed in place on every Newton step
    (natively at the first, on the device after it), and CG stays
    multigrid-like (tests/test_amg.py's bound)."""
    calls = {"build": 0, "refresh": 0}
    build, refresh = AMGPreconditioner._extract, AMGPreconditioner._extract_values

    def count(key, fn):
        def wrapped(self, *a):
            calls[key] += 1
            return fn(self, *a)
        return wrapped

    monkeypatch.setattr(AMGPreconditioner, "_extract", count("build", build))
    monkeypatch.setattr(AMGPreconditioner, "_extract_values",
                        count("refresh", refresh))
    prob = ElasticityProblem(Config(
        problem="hyperSS", degree=2, nu=0.3, E=1e6, forcing="none",
        box_faces=(2, 2, 2), bc_clamp=(6, 5),
        bc_clamp_translate={5: (0.0, 0.0, 0.05)}, num_increments=1,
        device="cpu"))
    info = prob.solve()
    assert info.converged and info.snes_iters >= 2
    # the first setup fills its values natively; every later refresh is
    # the device's
    assert calls == {"build": 1, "refresh": 1}
    device = prob._last_totals.counts.get("amg.device_refreshes", 0)
    assert device == prob.pc_setups - 1
    assert prob.pc_setups == info.snes_iters
    assert info.ksp_iters < 30 * info.snes_iters


@pytest.mark.parametrize("name,n,amg_kw,reps", [
    # -test: the whole boundary masked; level 0 matrix-free, as the
    # problem builds it
    ("hyperFS", 8, {"top_mf": True, "coarse_size": 10},
     ["mf", "dense", "none"]),
    ("hyperFS", 8, {"dense_n": 100, "coarse_size": 10},
     ["ell", "dense", "none"]),
    # composite: the pressure part's element matrices in the values
    ("hyperFSIncomp", 6, {"top_mf": True, "dense_n": 0, "coarse_size": 10},
     ["mf", "ell", "none"]),
])
def test_device_refresh_matches_native(name, n, amg_kw, reps):
    """The device refresh of one hierarchy at two more Jacobians against
    the native refresh on the same float64 values (amg_refresh_pair)."""
    prob = ElasticityProblem(Config(
        problem=name, degree=2, nu=0.3, E=1.0, test_mode=True,
        box_faces=(n, n, n), multigrid="logarithmic", device="cpu"))
    assert check_device_refresh(prob, (0, 1, 2), **amg_kw) == reps


def test_device_refresh_raises_on_non_finite_values():
    """Non-finite p = 1 values raise FloatingPointError from the device
    refresh, as from the native one (the continuation's diverged
    increment), and leave the levels' data as they were."""
    prob = ElasticityProblem(Config(
        problem="hyperFS", degree=2, nu=0.3, E=1.0, test_mode=True,
        box_faces=(6, 6, 6), multigrid="logarithmic", device="cpu"))
    asm = prob._assembler0
    v = prob.p1_values(prob._raw_residual(
        torch.zeros((3, prob.fine_space.num_nodes), dtype=torch.float64))[1])
    amg = AMGPreconditioner(torch.float64, "cpu", top_mf=True, coarse_size=10)
    amg.setup(asm.from_values(v.numpy()), source=asm)
    coarse_inv = amg.data["coarse_inv"]
    with pytest.raises(FloatingPointError):
        amg.refresh(torch.full_like(v, float("nan")))
    assert amg.data["coarse_inv"] is coarse_inv
    with pytest.raises(FloatingPointError):
        amg.setup(asm.from_values(np.full(v.numel(), np.nan)))


def test_degree1_amg_pc():
    """PCGAMG at degree 1 (elasticity.c:519-521): one level, CG
    preconditioned by the AMG cycle over the fine operator; KSP <= 15."""
    prob = _linelas_p1(6, multigrid="logarithmic")
    assert prob.level_degrees == [1] and prob._use_amg and not prob._use_mg
    info = prob.solve()
    assert info.converged
    assert info.ksp_iters <= 15


@pytest.mark.parametrize("multigrid,degree", [("logarithmic", 2),
                                              ("none", 2)])
def test_linear_model_builds_pc_once(monkeypatch, multigrid, degree):
    """A linear model's Jacobian never changes, so its preconditioner
    (p-MG diagonals and bounds, AMG; or the Jacobi diagonal) is built once
    a solve, not once per Newton step; the answer is the one of a solve
    that rebuilds it every step, to 1e-12."""
    def run(nonlinear):
        prob = ElasticityProblem(Config(
            problem="linElas", degree=degree, test_mode=True,
            box_faces=(2, 2, 2), multigrid=multigrid, num_increments=3,
            device="cpu"))
        monkeypatch.setattr(prob.model, "nonlinear", nonlinear)
        info = prob.solve()
        return prob, info

    prob, info = run(False)
    assert info.converged and info.snes_iters == 3
    assert prob.pc_setups == 1
    prob2, info2 = run(True)
    assert prob2.pc_setups == 3
    assert info2.ksp_iters == info.ksp_iters
    assert float((info.u - info2.u).abs().max()
                 / info2.u.abs().max()) <= 1e-12
