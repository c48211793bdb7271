"""The slice as a whole: the port's hyperFS Newton + Jacobi-CG solve against
the JAX ElasticityProblem (float64, CPU), the analytic Jacobian against
torch.func.jvp of the residual, and the CLI against the JAX CLI."""

import re

import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu import cli as jcli
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import cli as tcli
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem

SMOKE = ["-problem", "hyperFS", "-test", "-degree", "3", "-nu", "0.3", "-E",
         "1", "-dm_plex_box_faces", "3,3,3", "-multigrid", "none",
         "-num_steps", "1"]


def _cfg(C, **kw):
    return C(problem="hyperFS", degree=2, nu=0.3, E=1.0, test_mode=True,
             box_faces=(2, 2, 2), multigrid="none", num_increments=1, **kw)


def test_solve_matches_jax():
    jp = JProblem(_cfg(JConfig))
    ji = jp.solve()
    tp = TProblem(_cfg(TConfig, device="cpu"))
    assert tp.dtype == torch.float64
    ti = tp.solve()
    assert ti.converged and ji.converged
    assert ti.snes_iters == ji.snes_iters
    assert abs(ti.ksp_iters - ji.ksp_iters) <= 1
    je, te = jp.mms_error(ji.u), tp.mms_error(ti.u)
    assert abs(te - je) <= 1e-8 * abs(je)
    jw, tw = jp.strain_energy(ji.u), tp.strain_energy(ti.u)
    assert abs(tw - jw) <= 1e-8 * abs(jw)


def test_pc_lag_matches_jax(monkeypatch):
    """pc_lag=2: the preconditioner is rebuilt on every second Newton step
    and reused on the others (problem.py's refresh cadence), in both
    packages. SNES equal, KSP within 1, rel-L2 and energy to 1e-8; the
    port's setup ran fewer times than its linear solves."""
    calls = {"setup": 0, "solve": 0}
    setup, lsolve = TProblem._jacobi_setup, TProblem._linear_solve

    def count_setup(self, stash):
        calls["setup"] += 1
        return setup(self, stash)

    def count_solve(self, *args, **kw):
        calls["solve"] += 1
        return lsolve(self, *args, **kw)

    monkeypatch.setattr(TProblem, "_jacobi_setup", count_setup)
    monkeypatch.setattr(TProblem, "_linear_solve", count_solve)
    jp = JProblem(_cfg(JConfig, pc_lag=2))
    ji = jp.solve()
    tp = TProblem(_cfg(TConfig, device="cpu", pc_lag=2))
    ti = tp.solve()
    assert ti.converged and ji.converged
    assert ti.snes_iters == ji.snes_iters >= 2
    assert calls["solve"] >= 2 and calls["setup"] == (calls["solve"] + 1) // 2
    assert abs(ti.ksp_iters - ji.ksp_iters) <= 1
    je, te = jp.mms_error(ji.u), tp.mms_error(ti.u)
    assert abs(te - je) <= 1e-8 * abs(je)
    jw, tw = jp.strain_energy(ji.u), tp.strain_energy(ti.u)
    assert abs(tw - jw) <= 1e-8 * abs(jw)


def test_solve_independent_of_numbering():
    """The same box through the lattice numbering and through the
    scrambled (entity-class, every orientation) numbering: one problem, so
    the same Newton/CG counts, MMS error and energy up to roundoff."""
    from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh

    box = TProblem(_cfg(TConfig, device="cpu"))
    scr = TProblem(_cfg(TConfig, device="cpu"),
                   mesh=scrambled_box_mesh((2, 2, 2), seed=2))
    assert scr.fine_space.lattice_dims is None
    ib, isc = box.solve(), scr.solve()
    assert ib.snes_iters == isc.snes_iters
    assert abs(ib.ksp_iters - isc.ksp_iters) <= 1
    assert scr.mms_error(isc.u) == pytest.approx(box.mms_error(ib.u), rel=1e-10)
    assert scr.strain_energy(isc.u) == pytest.approx(box.strain_energy(ib.u),
                                                     rel=1e-10)


def test_jacobian_matches_jvp():
    """Analytic Newton linearization vs forward-mode AD of the residual
    (the port's counterpart of test_solve_mms.py's jax.jvp check)."""
    prob = TProblem(_cfg(TConfig, device="cpu"))
    rng = np.random.default_rng(7)
    N = prob.fine_space.num_nodes
    u = torch.as_tensor(rng.normal(size=(3, N)) * 0.02)
    bc = prob.bc_values(1.0)
    G, stash = prob._nonlinear_residual(u, bc, prob.F)
    v = torch.as_tensor(rng.normal(size=(3, N)))
    Jv = prob._jacobian_action(v, stash)
    _, jvp = torch.func.jvp(
        lambda x: prob._nonlinear_residual(x, bc, prob.F)[0], (u,),
        (torch.where(prob.bc_mask, 0.0, v),))
    assert float(torch.linalg.norm(Jv - jvp) / torch.linalg.norm(jvp)) < 1e-6


def test_bc_values_once_a_load_and_unchanged(monkeypatch):
    """bc_values evaluates the boundary conditions once a load and keeps
    them: two clamp solves of two increments each evaluate them at 0.5 and
    1.0 only; no caller changes a kept tensor, the mask or the forcing in
    place; the answers carry the full load's values at constrained DOFs."""
    prob = TProblem(TConfig(problem="hyperFS", degree=2, forcing="none",
                            box_faces=(2, 2, 2), bc_clamp=(6, 5),
                            bc_clamp_translate={5: (0.0, 0.0, 0.05)},
                            num_increments=2, device="cpu"))
    calls, real = [], prob.bcs.values

    def values(coords, load):
        calls.append(load)
        return real(coords, load)

    monkeypatch.setattr(prob.bcs, "values", values)
    kept = {load: prob.bc_values(load) for load in (0.5, 1.0)}
    before = {load: v.clone() for load, v in kept.items()}
    mask, F = prob.bc_mask.clone(), prob.F.clone()
    first, second = prob.solve(), prob.solve()
    assert first.converged and second.converged
    assert calls == [0.5, 1.0]
    for load, v in kept.items():
        assert prob.bc_values(load) is v
        assert torch.equal(v, before[load])
    assert torch.equal(prob.bc_mask, mask) and torch.equal(prob.F, F)
    for info in (first, second):
        assert torch.equal(info.u[mask], before[1.0][mask])


def _l2(out):
    m = re.search(r"L2 Error: (\S+)", out)
    return float(m.group(1)) if m else None


def test_cli_smoke_matches_jax(capsys, monkeypatch):
    """The reference smoke flags in hyperFS form: the port's CLI returns
    what the JAX CLI returns and prints the same MMS error. (Both return 1:
    manufacturedForce.h is manufactured for linElas, whose shear term
    carries mu where hyperFS's small-strain limit carries 2 mu, so the
    hyperFS MMS error stays near 6e-2 at any resolution.) The port's CLI
    runs on the CPU because the environment asks for it."""
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    rc_j = jcli.main(list(SMOKE))
    out_j = capsys.readouterr().out
    rc_t = tcli.main(list(SMOKE))
    out_t = capsys.readouterr().out
    assert rc_t == rc_j
    assert _l2(out_t) == pytest.approx(_l2(out_j), rel=1e-5)


def test_device_is_cuda_unless_the_cpu_is_asked_for(monkeypatch, capsys):
    """Without a CUDA device and without an ask for the CPU, the problem and
    the CLI raise instead of running on the CPU; asked for the CPU
    (Config(device="cpu"), or the CLI's environment setting), they run."""
    from ceedpetscsolid_tpu_torch.problem import select_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(tcli.DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TProblem(_cfg(TConfig))
    with pytest.raises(RuntimeError, match=tcli.DEVICE_ENV):
        tcli.main(list(SMOKE))
    assert select_device("cpu") == torch.device("cpu")
    assert TProblem(_cfg(TConfig, device="cpu")).device.type == "cpu"
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")
    assert tcli.main(list(SMOKE)) == 1          # as test_cli_smoke_matches_jax
    assert _l2(capsys.readouterr().out) is not None
