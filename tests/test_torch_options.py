"""Option paths and this slice's configurations, the port against the JAX
package (float64, CPU) on 2^3 boxes: whole solves with SNES and KSP equal
and |u_port - u_jax| <= 1e-10 |u_jax| (the two sum in another order; the
differences measured were at most 1.4e-12).

The option paths: constant forcing with the basic line search; clamp
rotation with Eisenstat-Walker forcing over 3 increments; unit scaling over
2 increments; -qextra in a solve; the uniform p-MG schedule with the
Chebyshev coarse solve. Of this slice's configurations, hyperFS -test at
degree 6 (Q = 7, on the CUDA generic tile); hyperFSIncomp with -qextra 1
and 2 under the default p-MG + AMG is in test_torch_incomp_qextra.py (two
JAX p-MG problems cost about as much as the rest of this file). One JAX
p-MG problem here (each costs about a minute of jit compile); the rest take
Jacobi CG. Eigenvalue estimates start from JAX's numbers
(`eig_start_vector` monkeypatched)."""

import numpy as np
import pytest

from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem
from ceedpetscsolid_tpu_torch.solve import cg as tcg
from test_torch_pmg import jax_start_vector

BOX = dict(box_faces=(2, 2, 2), degree=2, nu=0.3, E=1.0)
CLAMP = dict(forcing="none", bc_clamp=(6, 5))
INCOMP = dict(BOX, problem="hyperFSIncomp", nu=0.49, E=1e6, **CLAMP,
              bc_clamp_translate={5: (0.05, 0.0, 0.0)}, num_increments=1,
              nu_smoother=0.3)

OPTION_PATHS = {
    "linElas-constant-basic": (dict(
        BOX, problem="linElas", forcing="constant", bc_clamp=(6,),
        multigrid="none"), dict(linesearch="basic")),
    "hyperSS-rotate-ew-3-increments": (dict(
        BOX, problem="hyperSS", **CLAMP,
        bc_clamp_translate={5: (0.0, 0.0, 0.02)},
        bc_clamp_rotate={5: (0.0, 0.0, 1.0, 0.05)}, num_increments=3,
        multigrid="none"), dict(ew=True)),
    "hyperFS-rotate-units-2-increments": (dict(
        BOX, problem="hyperFS", **CLAMP,
        bc_clamp_rotate={5: (1.0, 0.0, 0.0, 0.05)}, units_meter=2.0,
        units_second=1.5, units_kilogram=3.0, num_increments=2,
        multigrid="none"), {}),
    "hyperFS-test-qextra1": (dict(
        BOX, problem="hyperFS", test_mode=True, qextra=1, num_increments=1,
        multigrid="none"), {}),
    "hyperFSIncomp-qextra1-jacobi": (dict(
        INCOMP, qextra=1, multigrid="none"), {}),
    "linElas-degree3-uniform-chebyshev": (dict(
        BOX, problem="linElas", degree=3, test_mode=True,
        multigrid="uniform", coarse_solve="chebyshev"), {}),
}

DEGREE6 = dict(BOX, problem="hyperFS", degree=6, test_mode=True,
               num_increments=1, multigrid="none")


def solve_pair(monkeypatch, kw, newton=None):
    """The same configuration in both packages, solved."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    jc, tc = JConfig(**kw), TConfig(**kw, device="cpu")
    for c in (jc, tc):
        for k, v in (newton or {}).items():
            setattr(c.newton, k, v)
    jp, tp = JProblem(jc), TProblem(tc)
    return (jp, jp.solve()), (tp, tp.solve())


def check_pair(j, t):
    (jp, ji), (tp, ti) = j, t
    assert ji.converged and ti.converged
    assert tp.level_degrees == jp.level_degrees
    assert (ti.snes_iters, ti.ksp_iters) == (ji.snes_iters, ji.ksp_iters)
    tu, ju = ti.u.numpy(), np.asarray(ji.u)
    assert np.linalg.norm(tu - ju) <= 1e-10 * np.linalg.norm(ju)
    jw, tw = jp.strain_energy(ji.u), tp.strain_energy(ti.u)
    assert abs(tw - jw) <= 1e-10 * abs(jw)
    return tp, ti


@pytest.mark.parametrize("case", list(OPTION_PATHS))
def test_option_paths_match_jax(case, monkeypatch):
    kw, newton = OPTION_PATHS[case]
    check_pair(*solve_pair(monkeypatch, kw, newton))


def test_degree6_matches_jax(monkeypatch):
    """hyperFS -test at degree 6, which on CUDA runs the generic tile at
    (7, 7); here the plain version, held to JAX."""
    tp, _ = check_pair(*solve_pair(monkeypatch, DEGREE6))
    assert tp.fine_space.degree == 6 and tp.factory.Q1d == 7
