"""hyperFSIncomp's composite operator (deviatoric mu part at full
quadrature + pressure part at one point per element) against the JAX
package (float64, CPU), and the port analogs of tests/test_incomp.py: the
analytic J.v against torch.func.jvp, and the nearly incompressible clamp
solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import interop
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem
from ceedpetscsolid_tpu_torch.solve import cg as tcg
from test_torch_pmg import jax_start_vector

CLAMP = dict(problem="hyperFSIncomp", degree=2, nu=0.49, E=1e6,
             forcing="none", box_faces=(2, 2, 2), bc_clamp=(6, 5),
             bc_clamp_translate={5: (0.05, 0.0, 0.0)}, num_increments=1,
             multigrid="logarithmic", nu_smoother=0.3)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def pair():
    """The clamp problem in both packages (levels [1, 2], native level
    quadrature, AMG coarse) at one seeded state u (strains ~1e-2)."""
    jp = JProblem(JConfig(**CLAMP))
    tp = TProblem(TConfig(**CLAMP, device="cpu"))
    u = np.random.default_rng(5).standard_normal(
        (3, tp.fine_space.num_nodes)) * 5e-3
    return jp, tp, u


def test_composite_operator_matches_jax(pair):
    """Residual, the (mu, pressure) stash pair and J.v, port vs JAX, to
    1e-12; the pressure stash has one point per element."""
    jp, tp, u = pair
    G_j, st_j = jp._nonlinear_residual(jnp.asarray(u), jp.bc_values(1.0),
                                       jp.F)
    G_t, st_t = tp._nonlinear_residual(torch.as_tensor(u), tp.bc_values(1.0),
                                       tp.F)
    assert _rel(G_t.numpy(), G_j) <= 1e-12
    assert isinstance(st_t, tuple) and st_t[1].shape == (9, tp.factory.nelem,
                                                         1)
    ref = interop.stash_pair_from_jax(
        jp.factory.stash_view(st_j[0]), jp.pfactory.stash_view(st_j[1]),
        tp.factory.nelem, tp.factory.Q3)
    for got, r in zip(st_t, ref):
        assert _rel(got.numpy(), r.numpy()) <= 1e-12
    v = np.random.default_rng(6).standard_normal(u.shape)
    jv_j = jp._jacobian_action(jnp.asarray(v), st_j)
    jv_t = tp._jacobian_action(torch.as_tensor(v), ref)
    assert _rel(jv_t.numpy(), jv_j) <= 1e-12


def test_composite_preconditioner_matches_jax(pair, monkeypatch):
    """At the same state: the level diagonals with the pressure term
    (1e-11), the Chebyshev bounds (1e-10, JAX's start vectors) and the
    assembled p = 1 matrix, mu part at the native level-0 quadrature plus
    the pressure part: the same CSR pattern, values to 1e-13."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    jp, tp, u = pair
    _, st_j = jp._nonlinear_residual(jnp.asarray(u), jp.bc_values(1.0), jp.F)
    st = interop.stash_pair_from_jax(
        jp.factory.stash_view(st_j[0]), jp.pfactory.stash_view(st_j[1]),
        tp.factory.nelem, tp.factory.Q3)
    dinv_j, bounds_j = jp._pc_setup_j(st_j, jp._big)
    levels, stash_nats = tp.build_mg_levels(st)
    dinv_t, bounds_t = tp.mg_setup(st, levels, stash_nats)
    for dt, dj in zip(dinv_t, dinv_j):
        assert _rel(dt.numpy(), dj) <= 1e-11
    for (lt, ht), (lj, hj) in zip(bounds_t, bounds_j):
        assert lt == pytest.approx(float(lj), rel=1e-10)
        assert ht == pytest.approx(float(hj), rel=1e-10)
    jasm = jp._assembler0
    vals_j = np.asarray(jp._emvals0(st_j, jp._big,
                                    jnp.asarray(jasm._inv.astype(np.int32))))
    vals_t = tp.p1_values(st, stash_nats)
    assert _rel(vals_t.numpy(), vals_j) <= 1e-13
    np.testing.assert_array_equal(tp._assembler0.indptr, jasm.indptr)
    np.testing.assert_array_equal(tp._assembler0.indices, jasm.indices)


def test_incomp_jacobian_matches_jvp():
    """Analytic J.v of the composite operator vs forward-mode AD of the
    residual, <= 1e-7 (tests/test_incomp.py's check)."""
    prob = TProblem(TConfig(problem="hyperFSIncomp", degree=2, nu=0.4, E=1.0,
                            test_mode=True, box_faces=(2, 2, 2),
                            num_increments=1, multigrid="none", device="cpu"))
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.normal(size=(3, prob.fine_space.num_nodes)) * 0.02)
    bc = prob.bc_values(1.0)
    G, stash = prob._nonlinear_residual(u, bc, prob.F)
    assert isinstance(stash, tuple) and stash[1].shape[-1] == 1
    v = torch.as_tensor(rng.normal(size=tuple(u.shape)))
    Jv = prob._jacobian_action(v, stash)
    _, jvp = torch.func.jvp(
        lambda x: prob._nonlinear_residual(x, bc, prob.F)[0], (u,),
        (torch.where(prob.bc_mask, 0.0, v),))
    assert float(torch.linalg.norm(Jv - jvp) / torch.linalg.norm(jvp)) < 1e-7


def test_incomp_clamp_solve_converges(pair):
    """The nearly incompressible clamp solve (nu = 0.49, smoother physics
    nu = 0.3) converges with a finite energy, as in the JAX package."""
    _, tp, _ = pair
    info = tp.solve()
    assert info.converged
    assert np.isfinite(tp.strain_energy(info.u))
