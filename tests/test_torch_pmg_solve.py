"""The slice as a whole with the p-multigrid preconditioner: the port's CLI
and ElasticityProblem against the JAX package's (float64, CPU), with the
Chebyshev coarse solve, native level quadrature (the default). The
fine-quadrature solve is in test_torch_pmg.py, beside the problem its
V-cycle test already built. Eigenvalue estimates start from JAX's numbers
(`eig_start_vector` monkeypatched)."""

import pytest

from ceedpetscsolid_tpu import cli as jcli
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import cli as tcli
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem
from ceedpetscsolid_tpu_torch.solve import cg as tcg
from test_torch_pmg import _cfg, check_solve_matches, jax_start_vector

PMG_FLAGS = ["-problem", "hyperFS", "-test", "-degree", "2", "-nu", "0.3",
             "-E", "1", "-dm_plex_box_faces", "2,2,2", "-multigrid",
             "logarithmic", "-coarse_pc_type", "chebyshev", "-num_steps", "1"]


def _spy_solve(monkeypatch, cls, into, key):
    """Record (problem, SolveInfo) of the next cls.solve call."""
    orig = cls.solve

    def solve(self, *args, **kw):
        info = orig(self, *args, **kw)
        into[key] = (self, info)
        return info

    monkeypatch.setattr(cls, "solve", solve)


def test_cli_pmg_matches_jax(capsys, monkeypatch):
    """Degree 2 on 2^3, levels [1, 2]: both CLIs return 0 and print
    nothing (MMS rel-L2 4.69e-02 < 0.05); the problems they solved agree
    (SNES equal, KSP within 1, rel-L2 and energy to 1e-8), and the port's
    rel-L2 is 4.693608e-02 to 1e-6."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    got = {}
    _spy_solve(monkeypatch, JProblem, got, "j")
    _spy_solve(monkeypatch, TProblem, got, "t")
    rc_j = jcli.main(list(PMG_FLAGS))
    out_j = capsys.readouterr().out
    rc_t = tcli.main(list(PMG_FLAGS))
    out_t = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_j, out_j) == (0, "")
    (jp, ji), (tp, ti) = got["j"], got["t"]
    assert tp.level_degrees == jp.level_degrees == [1, 2]
    assert ti.converged and ji.converged
    assert ti.snes_iters == ji.snes_iters
    assert abs(ti.ksp_iters - ji.ksp_iters) <= 1
    je, te = jp.mms_error(ji.u), tp.mms_error(ti.u)
    assert abs(te - je) <= 1e-8 * je
    assert te == pytest.approx(4.693608e-02, rel=1e-6)
    jw, tw = jp.strain_energy(ji.u), tp.strain_energy(ti.u)
    assert abs(tw - jw) <= 1e-8 * abs(jw)


def test_solve_native_levels_matches_jax(monkeypatch):
    """Degree 4 on 2^3, levels [1, 2, 4], native level quadrature, coarse
    Chebyshev(30): SNES equal, KSP within 1, rel-L2 and energy to 1e-8."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    check_solve_matches(JProblem(_cfg(JConfig, "native")),
                        TProblem(_cfg(TConfig, "native", device="cpu")))
