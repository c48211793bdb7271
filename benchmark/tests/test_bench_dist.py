"""The distributed cell's driver (benchmark/kinds/dist_solve.py) on two
gloo ranks on the CPU at a tiny box: it runs, is correct, reports every
per-layer metric its program spans feed, and each fault planted on a
rank comes out not correct; and the control at the cell's own size, on
the card (`gpu`, four devices)."""

from __future__ import annotations

import copy

import pytest

from benchmark import calibrate, common, run as brun

from . import dist_faults
from .conftest import cell_of_kind, cpu_run, tiny_cell

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _cell():
    cell = tiny_cell(cell_of_kind("dist_solve"))
    cell.config["ranks"] = 2
    return cell


def _line(cell, out):
    return brun.result_line(cell, out, True, {"platform": "cpu"})


def test_dist_solve_runs_and_reads():
    cell = _cell()
    out = common.kind("dist_solve").run(cpu_run(cell, seconds=0.5))
    assert out["attempted"] >= 1 and out["failed"] == 0
    line = _line(cell, out)
    assert line["correct"], line["checks"]
    for m in cell.per_layer:
        if m["source"] != "device_trace":
            assert line["metrics"][m["name"]]["value"] > 0, m["name"]
    # the exchanges, the preconditioner set-up and CG are parts of a solve
    ms = line["metrics"]
    assert ms["exchange_share.dist"]["value"] < 100
    assert ms["pc_share.dist"]["value"] < 100
    assert all(q["program"]["counts"]["amg.device_refreshes"]
               == q["program"]["counts"]["pc.builds"]
               for q in out["records"])


@pytest.mark.parametrize("fault", [dist_faults.unchanged_step,
                                   dist_faults.altered_answer])
def test_dist_solve_faults(fault):
    cell = _cell()
    out = common.kind("dist_solve").run(cpu_run(cell, trace=False),
                                        patch=fault)
    assert not _line(cell, out)["correct"]


def test_dist_solve_fails_without_the_device_refresh():
    """A window's solve whose AMG refresh went through the host fails the
    run."""
    cell = _cell()
    with pytest.raises(Exception, match="refreshed its AMG on the device"):
        common.kind("dist_solve").run(cpu_run(cell, trace=False),
                                      patch=dist_faults.native_refresh)


@pytest.mark.gpu
def test_dist_control_fails_at_the_cells_size():
    """The control (the reference in float32 with TF32 contractions,
    Newton with Jacobi CG, on the whole box on one card) reads above the
    limit on three seeds."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: the cell's own size")
    cell = common.load_cell(cell_of_kind("dist_solve"))
    newton = copy.deepcopy(cell)
    newton.traffic["kind"] = "solve"
    limit = cell.limits["residual"]["limit"]
    for seed in SEEDS:
        reading = calibrate.control_reading(newton, seed, "cuda:0")
        print(cell.name, seed, reading)
        assert reading["residual"] > limit
