"""The control of each cell's comparison: the float64 reference put in the
program's place and computed one precision step down, float32 with TF32
contractions (the configurations state float32 with TF32 off). It has to
come out not correct.

On the CPU at a small box beside the program's own reading there; marked
`gpu`, at the cell's own size on three seeds (run on the card with
`python -m pytest -p no:cacheprovider benchmark/tests -m gpu`)."""

from __future__ import annotations

import pytest

from benchmark import calibrate, common

from .conftest import CELLS, cpu_run

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    cell = common.load_cell(name)
    cell.config["box_faces"] = [3, 3, 3]
    (key, limit), = ((k, v["limit"]) for k, v in cell.limits.items())
    ctrl = calibrate.control_reading(cell, SEEDS[0], "cpu")[key]
    prog = common.kind(cell.traffic["kind"]).run(
        cpu_run(cell, seed=SEEDS[0], trace=False))["checks"][key][0]
    assert prog < limit < ctrl
    assert ctrl > 3 * prog


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    cell = common.load_cell(name)
    (key, limit), = ((k, v["limit"]) for k, v in cell.limits.items())
    for seed in SEEDS:
        reading = calibrate.control_reading(cell, seed, "cuda:0")
        print(name, seed, reading)
        assert reading[key] > limit
