"""Each traffic kind at a tiny box on the CPU, through the functions the
runner calls, and each fault the cell can have planted underneath: the
run comes out not correct.

Faults: a step that returns its state unchanged (a Newton step, a CG
iteration) and an answer altered where it is produced. No cell batches
requests and none spans cards, so the half-batch fault and the exchange
left out do not apply."""

from __future__ import annotations

import pytest
import torch

from benchmark import common, run as brun

from .conftest import CELLS, cell_of_kind, cpu_run, tiny_cell

def _line(cell, out, traced=True):
    return brun.result_line(cell, out, traced, {"platform": "cpu"})


@pytest.mark.parametrize("name", CELLS)
def test_kind_runs_and_is_correct(name):
    cell = tiny_cell(name)
    out = common.kind(cell.traffic["kind"]).run(cpu_run(cell))
    assert out["attempted"] >= 1 and out["failed"] == 0
    line = _line(cell, out)
    assert line["correct"], line["checks"]
    e2e = _line(cell, out, traced=False)["metrics"]
    assert set(e2e) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in e2e.values())
    # every per-layer metric but the device trace's has something to read
    # on the CPU
    for m in cell.per_layer:
        if m["source"] != "device_trace":
            assert m["name"] in line["metrics"], m["name"]


def _unchanged_newton(residual, linear_solve, u0, opts, floor_atol=0.0):
    from ceedpetscsolid_tpu_torch.solve.newton import NewtonResult

    return NewtonResult(u0, 1, 1, 0.0, True, "converged")


def _alter(u):
    u = u.clone()
    u[0, u.shape[1] // 2] += 0.1 * float(u.abs().max())
    return u


def test_solve_faults(monkeypatch):
    import ceedpetscsolid_tpu_torch.problem as P

    cell = tiny_cell(cell_of_kind("solve"))
    kind = common.kind(cell.traffic["kind"])
    with monkeypatch.context() as m:
        m.setattr(P, "newton_solve", _unchanged_newton)
        assert not _line(cell, kind.run(cpu_run(cell)))["correct"]
    solve = P.ElasticityProblem.solve

    def altered(self, *a, **kw):
        info = solve(self, *a, **kw)
        info.u = _alter(info.u)
        return info

    with monkeypatch.context() as m:
        m.setattr(P.ElasticityProblem, "solve", altered)
        assert not _line(cell, kind.run(cpu_run(cell)))["correct"]


def test_cg_faults(monkeypatch):
    import ceedpetscsolid_tpu_torch.problem as P
    from ceedpetscsolid_tpu_torch.solve.cg import CGResult

    cell = tiny_cell(cell_of_kind("cg_solve"))
    kind = common.kind(cell.traffic["kind"])
    pcg = P.pcg

    def unchanged(A, b, **kw):
        res = pcg(A, b, **kw)
        return res._replace(x=torch.zeros_like(b))

    def altered(A, b, **kw):
        res = pcg(A, b, **kw)
        return res._replace(x=_alter(res.x))

    for fault in (unchanged, altered):
        with monkeypatch.context() as m:
            m.setattr(P, "pcg", fault)
            assert not _line(cell, kind.run(cpu_run(cell)))["correct"]
    assert CGResult

