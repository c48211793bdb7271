"""Shared helpers of the benchmark's CPU tests: cells at a tiny size."""

from __future__ import annotations

import time

import pytest

from benchmark import common

TINY = [2, 2, 2]
SPEC = common.load_json(common.ROOT / "BENCHMARK.json")
CELLS = tuple(w["name"] for w in SPEC["workloads"])


def cell_of_kind(kind: str) -> str:
    """The first cell of BENCHMARK.json whose traffic mix is of `kind`."""
    return next(n for n in CELLS
                if common.load_cell(n).traffic["kind"] == kind)


def tiny_cell(name: str) -> common.Cell:
    """The cell as its files define it, its box cut to a few elements
    (every other setting as the files give it)."""
    cell = common.load_cell(name)
    cell.config["box_faces"] = list(TINY)
    return cell


def cpu_run(cell: common.Cell, seed: int = 2 ** 31 + 11, seconds=0.3,
            trace=True) -> common.Run:
    return common.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                      t_start=time.time(), device="cpu")


@pytest.fixture
def spec():
    return common.load_json(common.ROOT / "BENCHMARK.json")
