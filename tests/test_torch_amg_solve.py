"""Whole solves with the AMG against the JAX package (float64, CPU): the
reference's own smoke test through both CLIs (linElas, p-MG [1, 2, 3], AMG
coarse), the hyperSS clamp solve of tests/test_amg.py, and PCGAMG at
degree 1. Eigenvalue estimates start from JAX's numbers (`eig_start_vector`
monkeypatched)."""

import pytest

from ceedpetscsolid_tpu import cli as jcli
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import cli as tcli
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem
from ceedpetscsolid_tpu_torch.solve import cg as tcg
from test_torch_pmg import jax_start_vector
from test_torch_pmg_solve import _spy_solve

# elasticity.c:36, with every default: -problem linElas, -multigrid
# logarithmic, -coarse_pc_type gamg
REFERENCE_SMOKE = ["-test", "-degree", "3", "-nu", "0.3", "-E", "1",
                   "-dm_plex_box_faces", "3,3,3"]
HYPERSS_CLAMP = dict(problem="hyperSS", degree=2, nu=0.3, E=1e6,
                     forcing="none", box_faces=(2, 2, 2), bc_clamp=(6, 5),
                     bc_clamp_translate={5: (0.0, 0.0, 0.05)},
                     num_increments=1, multigrid="logarithmic")


def test_reference_smoke_matches_jax(capsys, monkeypatch):
    """Both CLIs are silent and return 0; both solves take SNES 1 and KSP
    8; the MMS rel-L2 agree to 1e-8 relative (2.85047e-04 in the JAX
    package); the AMG hierarchy is one level (192 p = 1 DOFs)."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    got = {}
    _spy_solve(monkeypatch, JProblem, got, "j")
    _spy_solve(monkeypatch, TProblem, got, "t")
    rc_j = jcli.main(list(REFERENCE_SMOKE))
    out_j = capsys.readouterr().out
    rc_t = tcli.main(list(REFERENCE_SMOKE))
    out_t = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_j, out_j) == (0, "")
    (jp, ji), (tp, ti) = got["j"], got["t"]
    assert tp.config.problem == "linElas" and tp._use_amg
    assert tp.level_degrees == jp.level_degrees == [1, 2, 3]
    assert (ti.snes_iters, ti.ksp_iters) == (ji.snes_iters, ji.ksp_iters) \
        == (1, 8)
    je, te = jp.mms_error(ji.u), tp.mms_error(ti.u)
    assert abs(te - je) <= 1e-8 * je
    assert te == pytest.approx(2.85047e-04, rel=1e-5)
    assert tp._amg.level_summary() == [(192, "none")]


def test_hyperss_clamp_matches_jax(monkeypatch):
    """The hyperSS clamp solve of tests/test_amg.py (p-MG [1, 2] + AMG,
    several Newton steps, so several AMG refreshes): equal SNES and KSP
    counts, strain energy to 1e-9 relative."""
    monkeypatch.setattr(tcg, "eig_start_vector", jax_start_vector)
    jp = JProblem(JConfig(**HYPERSS_CLAMP))
    tp = TProblem(TConfig(**HYPERSS_CLAMP, device="cpu"))
    ji, ti = jp.solve(), tp.solve()
    assert ji.converged and ti.converged
    assert (ti.snes_iters, ti.ksp_iters) == (ji.snes_iters, ji.ksp_iters)
    assert ti.snes_iters >= 2
    jw, tw = jp.strain_energy(ji.u), tp.strain_energy(ti.u)
    assert abs(tw - jw) <= 1e-9 * abs(jw)


def test_pcgamg_degree1_matches_jax(capsys):
    """-degree 1 under the default schedule: PCGAMG in both CLIs (-snes_view
    names it); the same KSP count and rel-L2 to 1e-8."""
    flags = ["-test", "-degree", "1", "-nu", "0.3", "-E", "1",
             "-dm_plex_box_faces", "4,4,4", "-snes_view"]
    rc_j = jcli.main(list(flags))
    out_j = capsys.readouterr().out
    rc_t = tcli.main(list(flags))
    out_t = capsys.readouterr().out
    assert rc_t == rc_j
    assert "PC Object: gamg(native SA-AMG)" in out_t
    assert "PC Object: gamg(native SA-AMG)" in out_j
    jp = JProblem(JConfig(problem="linElas", degree=1, test_mode=True,
                          box_faces=(4, 4, 4)))
    tp = TProblem(TConfig(problem="linElas", degree=1, test_mode=True,
                          box_faces=(4, 4, 4), device="cpu"))
    ji, ti = jp.solve(), tp.solve()
    assert ti.converged and ji.converged
    assert (ti.snes_iters, ti.ksp_iters) == (ji.snes_iters, ji.ksp_iters)
    je, te = jp.mms_error(ji.u), tp.mms_error(ti.u)
    assert abs(te - je) <= 1e-8 * je


def test_default_coarse_solve_is_amg(capsys):
    """-coarse_pc_type gamg, the default, is the AMG coarse solve; the
    -snes_view coarse line is the JAX CLI's."""
    cfg, _ = tcli.build_config(tcli._parse_args(
        ["-test", "-nu", "0.3", "-E", "1"]))
    assert cfg.coarse_solve == "amg"
    assert TConfig(problem="hyperFS", degree=2, test_mode=True,
                   device="cpu").coarse_solve == "amg"
    rc = tcli.main(["-problem", "hyperFS", "-test", "-degree", "2", "-nu",
                    "0.3", "-E", "1", "-dm_plex_box_faces", "2,2,2",
                    "-num_steps", "1", "-snes_view"])
    out = capsys.readouterr().out
    assert rc == 0
    assert ("    coarse: (coarse_) native SA-AMG V-cycle on assembled p=1 "
            "CSR") in out.splitlines()
