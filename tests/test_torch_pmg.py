"""The p-multigrid pieces of the port against the JAX package (float64, CPU):
the Chebyshev smoother, the eigenvalue-bound estimate, the level transfers,
the level operators (native and fine quadrature), and one V-cycle on the
JAX package's own preconditioner data. Tolerances are stated per test; the
two sides differ only in summation order.

JAX's random start vector for the eigenvalue estimate cannot be reproduced
in torch, so the tests hand the port JAX's numbers
(`eig_start_vector` monkeypatched), never the seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.mesh.fespace import build_fespace as jbuild
from ceedpetscsolid_tpu.models import Physics as JPhysics
from ceedpetscsolid_tpu.models import hyper_fs as jhfs
from ceedpetscsolid_tpu.ops.operator import OperatorFactory as JFactory
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu.solve import cg as jcg
from ceedpetscsolid_tpu.solve.pmg import make_vcycle as jmake_vcycle
from ceedpetscsolid_tpu_torch import interop
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace as tbuild
from ceedpetscsolid_tpu_torch.models import hyper_fs as thfs
from ceedpetscsolid_tpu_torch.ops.assembly import (diagonal_weights,
                                                   element_diagonal_of,
                                                   pointwise_tangent)
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory as TFactory
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem
from ceedpetscsolid_tpu_torch.solve import cg as tcg
from ceedpetscsolid_tpu_torch.solve.pmg import make_vcycle as tmake_vcycle
from test_torch_mesh import mesh_pair

JPHYS = JPhysics(nu=0.3, E=1.0)
TPHYS = interop.physics_from_jax(JPHYS)
DEGREES = (1, 2, 4)                 # logarithmic levels under degree 4


def jax_start_vector(shape, dtype, device):
    """The JAX package's start vector (ceedpetscsolid_tpu/solve/cg.py:
    166-168), as numbers."""
    v = jax.random.uniform(jax.random.PRNGKey(0), shape, jnp.float64) - 0.5
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _spd(n, seed):
    """A dense SPD matrix with eigenvalues in [1, 100] and a varied
    diagonal."""
    rng = np.random.default_rng(seed)
    Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Qm * np.geomspace(1.0, 100.0, n)) @ Qm.T


@pytest.mark.parametrize("with_x0", [False, True])
def test_chebyshev_matches_jax(with_x0):
    """Same SPD matrix, b, diag_inv, bounds and x0: 1e-12 relative."""
    A = _spd(48, 1)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((3, 16))
    x0 = rng.standard_normal((3, 16)) if with_x0 else None
    dinv = (1.0 / np.diag(A)).reshape(3, 16)
    lo, hi = 0.3, 120.0 * float(dinv.max())

    def jA(v):
        return (jnp.asarray(A) @ v.reshape(-1)).reshape(3, 16)

    def tA(v):
        return (torch.as_tensor(A) @ v.reshape(-1)).reshape(3, 16)

    xj = jcg.chebyshev(jA, jnp.asarray(b), jnp.asarray(dinv), lo, hi, 7,
                       x0=None if x0 is None else jnp.asarray(x0))
    xt = tcg.chebyshev(tA, torch.as_tensor(b), torch.as_tensor(dinv), lo, hi,
                       7, x0=None if x0 is None else torch.as_tensor(x0))
    assert _rel(xt.numpy(), xj) <= 1e-12


def test_chebyshev_from_zero_skips_the_zero_apply():
    """From a zero guess the smoother starts at D^-1 b / theta: iters - 1
    applications of A, and the result equals (torch.equal) the recurrence
    that applies A to the zero vector first, here with a BC-masked
    operator as the level operators are."""
    A = torch.as_tensor(_spd(48, 4))
    rng = np.random.default_rng(6)
    mask = torch.as_tensor(rng.random((3, 16)) < 0.25)
    b = torch.where(mask, 0.0, torch.as_tensor(rng.standard_normal((3, 16))))
    dinv = torch.where(mask, 1.0, 1.0 / torch.diagonal(A).reshape(3, 16))
    lo, hi = 0.3, 120.0 * float(dinv.max())
    calls = [0]

    def apply(v):
        calls[0] += 1
        Av = (A @ torch.where(mask, 0.0, v).reshape(-1)).reshape(3, 16)
        return torch.where(mask, 0.0, Av)

    for iters in (1, 3, 30):
        calls[0] = 0
        x = tcg.chebyshev(apply, b, dinv, lo, hi, iters)
        assert calls[0] == iters - 1
        ref = tcg.chebyshev(apply, b, dinv, lo, hi, iters,
                            x0=torch.zeros_like(b))
        assert calls[0] == 2 * iters - 1
        assert torch.equal(x, ref)


def test_estimate_extreme_eigs_matches_jax(monkeypatch):
    """JAX's start vector handed to the port: bounds to 1e-10 relative,
    and the upper bound is 1.1 x an estimate of lambda_max(D^-1 A)."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    A = _spd(60, 3)
    dinv = (1.0 / np.diag(A)).reshape(3, 20)
    lo_j, hi_j = jcg.estimate_extreme_eigs(
        lambda v: (jnp.asarray(A) @ v.reshape(-1)).reshape(3, 20),
        jnp.asarray(dinv), (3, 20), jnp.float64)
    lo_t, hi_t = tcg.estimate_extreme_eigs(
        lambda v: (torch.as_tensor(A) @ v.reshape(-1)).reshape(3, 20),
        torch.as_tensor(dinv), (3, 20), torch.float64)
    assert lo_t == pytest.approx(float(lo_j), rel=1e-10)
    assert hi_t == pytest.approx(float(hi_j), rel=1e-10)
    lmax = np.linalg.eigvals(dinv.reshape(-1)[:, None] * A).real.max()
    assert 0.9 * 1.1 * lmax <= hi_t <= 1.1 * lmax * (1 + 1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eig_estimate_survives_krylov_breakdown(dtype):
    """When the Krylov space is exhausted before the 10 steps (here D^-1 A
    = I: r = 0 after one step, the next coefficients are 0/0), the bounds
    come from the Lanczos steps before the breakdown: exactly (0.1, 1.1)
    x lambda_max = 1. The JAX package returns NaN bounds here, which a
    coarse level with fewer free DOFs than steps (or a float32 r that
    reaches 0) would feed to its Chebyshev smoother."""
    lo_j, hi_j = jcg.estimate_extreme_eigs(
        lambda v: v, jnp.ones((3, 2)), (3, 2), jnp.float64)
    assert np.isnan(float(lo_j)) and np.isnan(float(hi_j))
    lo, hi = tcg.estimate_extreme_eigs(lambda v: v, torch.ones((3, 2),
                                                               dtype=dtype),
                                       (3, 2), dtype)
    assert (lo, hi) == pytest.approx((0.1, 1.1), rel=1e-12)


def _factories(kind, n=2):
    jm, tm = mesh_pair(kind, n)
    jf = JFactory([jbuild(jm, d) for d in DEGREES], dtype=jnp.float64,
                  use_pallas=False, use_spectral=False)
    tf = TFactory([tbuild(tm, d) for d in DEGREES], dtype=torch.float64,
                  device="cpu")
    return jf, tf


@pytest.mark.parametrize("kind", ["box", "scrambled"])
@pytest.mark.parametrize("coarse", [0, 1])           # 1 -> 2 and 2 -> 4
def test_transfers_match_jax(kind, coarse):
    """Prolong and restrict, JAX vs port, to 1e-12; and restrict is the
    exact transpose of prolong, <P x, y> = <x, R y>, to 1e-12."""
    jf, tf = _factories(kind)
    fine = coarse + 1
    jpro, jres = jf.make_prolongation(coarse, fine)
    jrc, jrf = jf.levels[coarse].restr, jf.levels[fine].restr
    jim = jf.fine_inv_multiplicity(fine)
    tpro, tres = tf.make_prolongation(coarse, fine)
    rng = np.random.default_rng(5 + coarse)
    x = rng.standard_normal((3, tf.levels[coarse].space.num_nodes))
    y = rng.standard_normal((3, tf.levels[fine].space.num_nodes))
    Px, Ry = tpro(torch.as_tensor(x)), tres(torch.as_tensor(y))
    assert _rel(Px.numpy(), jpro(jnp.asarray(x), jrc, jrf, jim)) <= 1e-12
    assert _rel(Ry.numpy(), jres(jnp.asarray(y), jrc, jrf, jim)) <= 1e-12
    lhs, rhs = float((Px.numpy() * y).sum()), float((x * Ry.numpy()).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def _tangent_diag(tf, level, basis, qdata, stash):
    """The port's level diagonal as ElasticityProblem builds it: the
    element diagonals of the pointwise tangent at the rule, owner-summed."""
    K = pointwise_tangent(thfs.jacobian_qf, TPHYS, qdata, stash)
    return tf.levels[level].restr.scatter_add(
        element_diagonal_of(K, diagonal_weights(basis)))


@pytest.mark.parametrize("kind", ["box", "scrambled"])
@pytest.mark.parametrize("level", [0, 1])
def test_level_operators_match_jax(kind, level):
    """From the same u: native qdata, the native stash, level J.v at the
    native and at the fine quadrature, and both level diagonals, JAX vs
    port to 1e-11 relative. Qdata and stashes cross through interop."""
    jf, tf = _factories(kind)
    rng = np.random.default_rng(11 + level)
    N = tf.space.num_nodes
    u = rng.standard_normal((3, N)) * 1e-2 / 2
    v = rng.standard_normal((3, tf.levels[level].space.num_nodes))
    jq = jf.compute_qdata()
    _, jst = jf.make_residual_structured(jhfs.residual_planes, JPHYS)(
        jnp.asarray(u), jq, jf.fine.srestr, jf.fine.sgrad)
    tq = interop.qdata_from_jax(jq, tf.nelem, tf.Q3, device="cpu")
    tst = interop.stash_from_jax(jst, tf.nelem, tf.Q3, device="cpu")
    jl, tl = jf.levels[level], tf.levels[level]

    # native quadrature
    jqn = jf.compute_qdata_native(level)
    jstn = jf.stash_to_native(jst, level)
    tqn = tf.compute_qdata_native(level)
    tstn = tf.stash_to_native(tst, level)
    Q3n = tf.levels[level].nat_basis.Q3
    assert _rel(tqn.numpy(), jqn) <= 1e-11
    assert _rel(tstn.numpy(), interop.stash_from_jax(jstn, tf.nelem, Q3n,
                                                         device="cpu")
                ) <= 1e-11
    jjv = jf.make_jacobian_native(jhfs.jacobian_planes, JPHYS, level)(
        jnp.asarray(v), jqn, jstn, jl.srestr, jl.nat_sgrad)
    tjv = tf.make_jacobian_native("hyperFS", TPHYS, level)(torch.as_tensor(v), tqn, tstn)
    assert _rel(tjv.numpy(), jjv) <= 1e-11
    jd = jf.make_diagonal(jhfs.jacobian_qf, JPHYS, level=level, native=True)(
        jqn, jstn, jl.restr)
    td = _tangent_diag(tf, level, tl.nat_basis, tqn, tstn)
    assert _rel(td.numpy(), jd) <= 1e-11

    # fine quadrature (P_l -> Q_fine)
    jjv = jf.make_jacobian_structured(jhfs.jacobian_planes, JPHYS,
                                      level=level)(
        jnp.asarray(v), jq, jst, jl.srestr, jl.sgrad)
    tjv = tf.make_jacobian_structured("hyperFS", TPHYS, level=level)(
        torch.as_tensor(v), tq, tst)
    assert _rel(tjv.numpy(), jjv) <= 1e-11
    jd = jf.make_diagonal(jhfs.jacobian_qf, JPHYS, level=level)(
        jq, jst, jl.restr)
    td = _tangent_diag(tf, level, tl.basis, tq, tst)
    assert _rel(td.numpy(), jd) <= 1e-11


# ---------------------------------------------------------------------------
# one V-cycle, on the JAX package's own mg_setup output
# ---------------------------------------------------------------------------
def _cfg(C, lq, **kw):
    return C(problem="hyperFS", degree=4, nu=0.3, E=1.0, test_mode=True,
             box_faces=(2, 2, 2), multigrid="logarithmic",
             coarse_solve="chebyshev", num_increments=1,
             level_quadrature=lq, **kw)


@functools.lru_cache(maxsize=None)
def jax_problem(lq):
    """One JAX problem per level quadrature for this file (each costs about
    a minute of jit compile on the CPU)."""
    return JProblem(_cfg(JConfig, lq))


def check_solve_matches(jp, tp):
    """Whole solve, JAX vs port: converged, SNES equal, KSP within 1, MMS
    rel-L2 and strain energy to 1e-8 relative. Returns the port's
    (info, rel-L2)."""
    ji, ti = jp.solve(), tp.solve()
    assert ji.converged and ti.converged
    assert ti.snes_iters == ji.snes_iters
    assert abs(ti.ksp_iters - ji.ksp_iters) <= 1
    je, te = jp.mms_error(ji.u), tp.mms_error(ti.u)
    assert abs(te - je) <= 1e-8 * je
    jw, tw = jp.strain_energy(ji.u), tp.strain_energy(ti.u)
    assert abs(tw - jw) <= 1e-8 * abs(jw)
    return ti, te


@pytest.fixture(scope="module", params=["native", "fine"])
def vcycle_case(request):
    """Both problems at one state u (small, seeded), the JAX mg_setup
    output there, and the JAX V-cycle applied to a seeded b."""
    lq = request.param
    jp = jax_problem(lq)
    tp = TProblem(_cfg(TConfig, lq, device="cpu"))
    assert jp.level_degrees == tp.level_degrees == [1, 2, 4]
    rng = np.random.default_rng(21)
    N = tp.fine_space.num_nodes
    u = rng.standard_normal((3, N)) * 5e-3
    b = np.where(np.asarray(jp.bc_mask), 0.0, rng.standard_normal((3, N)))
    _, jst = jp._nonlinear_residual(jnp.asarray(u), jp.bc_values(1.0), jp.F)
    diag_invs, bounds = jp._pc_setup_j(jst, jp._big)
    jlevels = jp._build_mg_levels(jst, jp._big)
    jx = jmake_vcycle(jlevels, smooth_its=3, coarse_cheb_its=30)(
        jnp.asarray(b), jst, list(diag_invs), list(bounds))
    tst = interop.stash_from_jax(jp.factory.stash_view(jst), tp.factory.nelem,
                                 tp.factory.Q3, device="cpu")
    return dict(jp=jp, tp=tp, b=b, tst=tst, pc=(diag_invs, bounds),
                jx=np.asarray(jx))


def test_vcycle_matches_jax(vcycle_case):
    """JAX's diagonals and Chebyshev bounds through interop.pc_from_jax, the
    same stash and b: the same V-cycle result to 1e-10 relative."""
    c = vcycle_case
    tp = c["tp"]
    for jm, tl in zip(c["jp"]._big["level_masks"], tp._level_masks):
        assert torch.equal(interop.mask_from_jax(jm, device="cpu"), tl)
    pc = interop.pc_from_jax(*c["pc"], device="cpu")
    levels, _ = tp.build_mg_levels(c["tst"])
    tx = tmake_vcycle(levels, smooth_its=3, coarse_cheb_its=30)(
        torch.as_tensor(c["b"]), c["tst"], *pc)
    assert _rel(tx.numpy(), c["jx"]) <= 1e-10


def test_mg_setup_matches_jax(vcycle_case, monkeypatch):
    """The port's own per-level diagonals (1e-11) and Chebyshev bounds
    (1e-10, JAX's start vectors) at the same state."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    c = vcycle_case
    tp = c["tp"]
    levels, stash_nats = tp.build_mg_levels(c["tst"])
    dinv_t, bounds_t = tp.mg_setup(c["tst"], levels, stash_nats)
    dinv_j, bounds_j = c["pc"]
    for dt, dj in zip(dinv_t, dinv_j):
        assert _rel(dt.numpy(), dj) <= 1e-11
    for (lt, ht), (lj, hj) in zip(bounds_t, bounds_j):
        assert lt == pytest.approx(float(lj), rel=1e-10)
        assert ht == pytest.approx(float(hj), rel=1e-10)


def test_solve_fine_levels_matches_jax(monkeypatch):
    """The whole p-MG solve with fine-quadrature levels, degree 4 on 2^3
    (levels [1, 2, 4], coarse Chebyshev(30)), JAX's start vectors."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    check_solve_matches(jax_problem("fine"),
                        TProblem(_cfg(TConfig, "fine", device="cpu")))
