"""Continuation control in the port against the JAX package (float64, CPU):
stopping at a load (Config.stop_at_load), resuming from a checkpoint
(solve(u0=, start_load=, floor_atol0=)), from the port's own and from a JAX
checkpoint, the failed-increment retries (Config.substep_retries), the CP
line search's secant steps (NewtonOptions.ls_max_it), on the solves and on
a toy residual through every branch, and the -snes_view line that names
them.

The problems are hyperFS clamps on the 2^3 box at degree 2 with Jacobi CG,
shared by the tests through module fixtures; a test that changes a knob of
a shared problem restores it."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu import cli as jcli
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import cli as tcli
from ceedpetscsolid_tpu_torch import interop
from ceedpetscsolid_tpu_torch.problem import Config as TConfig
from ceedpetscsolid_tpu_torch.problem import ElasticityProblem as TProblem

BASE = dict(problem="hyperFS", degree=2, nu=0.3, E=1.0, box_faces=(2, 2, 2),
            multigrid="none", bc_clamp=(6, 5))
# four increments of a stretch with shear; every one converges
CLAMP = dict(BASE, bc_clamp_translate={5: (0.2, 0.0, 0.1)}, num_increments=4)
# a lift with a quarter turn in two increments: five Newton steps each, on
# which the line searches take different step lengths
BEND = dict(BASE, bc_clamp_translate={5: (0.0, 0.0, 0.3)},
            bc_clamp_rotate={5: (1.0, 0.0, 0.0, 0.25)}, num_increments=2)
# a 30% stretch in one increment: four Newton steps, so at max_it 3 the
# full increment fails and the halved load converges
STRETCH = dict(BASE, bc_clamp_translate={5: (0.3, 0.0, 0.0)},
               num_increments=1)


def _pair(kw):
    return JProblem(JConfig(**kw)), TProblem(TConfig(**kw, device="cpu"))


@pytest.fixture(scope="module")
def clamp():
    return _pair(CLAMP)


@pytest.fixture(scope="module")
def bend():
    return _pair(BEND)


@pytest.fixture(scope="module")
def stretch():
    return _pair(STRETCH)


@contextlib.contextmanager
def knobs(probs, newton=(), **config):
    """Set Config fields and NewtonOptions fields (`newton`, pairs) of each
    problem for the block, and restore them after."""
    saved = []
    for p in probs:
        for obj, kv in ((p.config, config.items()),
                        (p.config.newton, dict(newton).items())):
            for k, v in kv:
                saved.append((obj, k, getattr(obj, k)))
                setattr(obj, k, v)
    try:
        yield
    finally:
        for obj, k, v in reversed(saved):
            setattr(obj, k, v)


def _solve(prob, **kw):
    """(SolveInfo, monitor log: (inc, load, SNES, KSP, converged) per
    Newton solve, checkpoint (u, load, floor) of the last converged one)."""
    log, ckpt = [], {"floor": 0.0}

    def monitor(inc, load, res):
        log.append((inc, round(load, 12), res.iters, res.linear_iters,
                    bool(res.converged)))
        if res.converged:
            ckpt.update(u=res.u, load=load,
                        floor=max(ckpt["floor"], float(res.rnorm)))

    return prob.solve(monitor=monitor, **kw), log, ckpt


def _u_close(got, ref, rtol):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_stop_at_load_matches_jax(clamp):
    """stop_at_load 0.5 of four increments: both packages run the first
    two and stop; the same SNES and KSP counts, u to 1e-12."""
    jp, tp = clamp
    with knobs(clamp, stop_at_load=0.5):
        ji, jlog, _ = _solve(jp)
        ti, tlog, _ = _solve(tp)
    assert [r[:2] for r in tlog] == [(1, 0.25), (2, 0.5)]
    assert tlog == jlog
    assert ti.converged and ji.converged
    assert (ti.snes_iters, ti.ksp_iters) == (ji.snes_iters, ji.ksp_iters)
    _u_close(ti.u, ji.u, 1e-12)


def test_resume_equals_unbroken(clamp):
    """The port stopped at load 0.5, then resumed in a fresh problem from
    the checkpoint its monitor took, against its unbroken solve: the same
    total SNES and KSP counts, u to 1e-13."""
    _, tp = clamp
    ui, ulog, _ = _solve(tp)
    with knobs([tp], stop_at_load=0.5):
        si, _, ck = _solve(tp)
    assert ck["load"] == 0.5
    fresh = TProblem(TConfig(**CLAMP, device="cpu"))
    ri, rlog, _ = _solve(fresh, u0=ck["u"], start_load=ck["load"],
                         floor_atol0=ck["floor"])
    assert [r[:2] for r in rlog] == [(3, 0.75), (4, 1.0)]
    assert ri.converged and ui.converged
    assert si.snes_iters + ri.snes_iters == ui.snes_iters
    assert si.ksp_iters + ri.ksp_iters == ui.ksp_iters
    _u_close(ri.u, ui.u, 1e-13)


def test_resume_from_jax_checkpoint(clamp):
    """A JAX checkpoint at load 0.5, (u_from_jax(u), load, floor), resumed
    by the port, ends where JAX's unbroken solve ends: the same total SNES
    and KSP counts, u to 1e-12."""
    jp, tp = clamp
    ji, _, _ = _solve(jp)
    with knobs([jp], stop_at_load=0.5):
        si, _, ck = _solve(jp)
    ri, _, _ = _solve(tp, u0=interop.u_from_jax(ck["u"], device="cpu"),
                      start_load=ck["load"], floor_atol0=ck["floor"])
    assert ri.converged and ji.converged
    assert si.snes_iters + ri.snes_iters == ji.snes_iters
    assert si.ksp_iters + ri.ksp_iters == ji.ksp_iters
    _u_close(ri.u, ji.u, 1e-12)


def test_resume_takes_any_array(clamp):
    """u0 is converted to the problem's dtype and device: a float32 numpy
    checkpoint resumes a float64 problem as its float64 tensor does."""
    _, tp = clamp
    u = np.asarray(_solve(tp)[0].u, np.float32)     # a converged state
    a = tp.solve(u0=u, start_load=0.75)
    b = tp.solve(u0=torch.as_tensor(u, dtype=torch.float64), start_load=0.75)
    assert a.snes_iters == b.snes_iters and torch.equal(a.u, b.u)


def _same_newton_path(tlog, jlog):
    """The same Newton solves (increment, load, SNES count, verdict) in
    the same order, and KSP within 1 of JAX's in each: CG's exit at rtol
    1e-10 may cross its threshold one iteration apart on roundoff alone
    (as in tests/test_torch_problem.py)."""
    assert [r[:3] + r[4:] for r in tlog] == [r[:3] + r[4:] for r in jlog]
    assert all(abs(t[3] - j[3]) <= 1 for t, j in zip(tlog, jlog))


@pytest.mark.parametrize("retries", [0, 4])
def test_substep_retries_match_jax(stretch, retries):
    """At max_it 3 the stretch's full increment fails: with 0 retries both
    packages stop there unconverged (the reference's behaviour), with 4
    both halve the load and converge; the same Newton path, totals within
    a KSP iteration per Newton solve, the same verdict, u to 1e-10."""
    jp, tp = stretch
    with knobs(stretch, newton=[("max_it", 3)], substep_retries=retries):
        ji, jlog, _ = _solve(jp)
        ti, tlog, _ = _solve(tp)
    _same_newton_path(tlog, jlog)
    assert tlog[0][4] is False
    assert ti.converged == ji.converged == (retries > 0)
    assert ti.snes_iters == ji.snes_iters
    assert abs(ti.ksp_iters - ji.ksp_iters) <= len(tlog)
    if retries:
        assert [r[1] for r in tlog] == [1.0, 0.5, 1.0]
        _u_close(ti.u, ji.u, 1e-10)


@pytest.mark.parametrize("linesearch,ls_max_it", [("cp", 0), ("cp", 2),
                                                  ("cp", 3), ("basic", 1)])
def test_line_search_matches_jax(bend, linesearch, ls_max_it):
    """The line searches JAX runs step by step (newton.py:263-301): no
    secant step, two or three, and the basic full step: the same Newton
    path, totals within a KSP iteration per Newton solve, u to 1e-10."""
    jp, tp = bend
    newton = [("linesearch", linesearch), ("ls_max_it", ls_max_it)]
    with knobs(bend, newton=newton):
        ji, jlog, _ = _solve(jp)
        ti, tlog, _ = _solve(tp)
    _same_newton_path(tlog, jlog)
    assert ti.converged and ji.converged
    assert ti.snes_iters == ji.snes_iters
    assert abs(ti.ksp_iters - ji.ksp_iters) <= len(tlog)
    _u_close(ti.u, ji.u, 1e-10)


def _toy_residuals(limit):
    """G(x) = x^3 + x - b elementwise, non-finite where any x > limit (a
    domain like hyperFS's J > 0), for JAX and for torch."""
    b = np.linspace(0.5, 2.0, 7)

    def jres(x):
        g = x ** 3 + x - jnp.asarray(b)
        return jnp.where(jnp.max(x) > limit, jnp.nan, g), None

    def tres(x):
        g = x ** 3 + x - torch.as_tensor(b)
        return (torch.full_like(g, float("nan")) if float(x.max()) > limit
                else g), None

    return jres, tres


@pytest.mark.parametrize("limit,scale", [
    (np.inf, 1.0),      # secant steps converge toward the critical point
    (np.inf, -1.0),     # an uphill direction: the secant step leaves bounds
    (np.inf, 1e-12),    # g barely moves: a secant step above 1e2
    (1.5, 4.0),         # the trial step leaves the domain: halve, restart
    (-1.0, 1.0),        # no trial step is finite: length 0
])
@pytest.mark.parametrize("ls_max_it", [0, 1, 2, 3, 5])
def test_secant_search_matches_jax(limit, scale, ls_max_it):
    """solve.newton.secant_search against the JAX package's _line_search
    on a toy residual, through every branch (secant restarts, the in-search
    domain halvings, the bounds, length 0): the same step length to 1e-14."""
    from ceedpetscsolid_tpu.solve.newton import NewtonOptions as JOpts
    from ceedpetscsolid_tpu.solve.newton import _line_search
    from ceedpetscsolid_tpu_torch.solve.newton import NewtonOptions as TOpts
    from ceedpetscsolid_tpu_torch.solve.newton import secant_search

    jres, tres = _toy_residuals(limit)
    u = np.full(7, 0.1)
    d = scale * np.linspace(1.0, 2.0, 7)
    G = u ** 3 + u - np.linspace(0.5, 2.0, 7)      # the finite entry state
    ref = _line_search(jres, jnp.asarray(u), jnp.asarray(G), jnp.asarray(d),
                       JOpts(ls_max_it=ls_max_it))
    got = secant_search(tres, torch.as_tensor(u), torch.as_tensor(G),
                        torch.as_tensor(d), TOpts(ls_max_it=ls_max_it))
    assert got == pytest.approx(float(ref), rel=1e-14, abs=0.0)


@pytest.mark.parametrize("ls_max_it", [1, 3])
def test_snes_view_line_matches_jax(clamp, capsys, ls_max_it):
    """-snes_view's solver tree, the line search's secant steps in it,
    printed as the JAX CLI prints it."""
    jp, tp = clamp
    with knobs(clamp, newton=[("ls_max_it", ls_max_it)]):
        jcli._print_solver_view(jp.config, jp)
        out_j = capsys.readouterr().out
        tcli._print_solver_view(tp.config, tp)
        out_t = capsys.readouterr().out
    assert f"  line search: cp (max {ls_max_it} secant steps)" in \
        out_t.splitlines()
    assert out_t == out_j
