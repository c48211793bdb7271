"""What every part of the harness shares: the spec files found by name,
the seeded inputs, the device record and the check for JAX.

A cell (`BENCHMARK.json` `workloads`) names a configuration and a traffic
mix. Each is a data file of its own, found by name:

  benchmark/configs/<config>.json    the deployment: model, solver,
                                     precision, mesh, ranks
  benchmark/traffic/<traffic>.json   the requests: `kind` names the driver
                                     (benchmark/kinds/<kind>.py) and the rest
                                     are its parameters
  benchmark/limits/<workload>.json   each number compared, its limit and
                                     the readings the limit was set from
  benchmark/metrics/<metric>.py      one reader a per-layer metric

so a cell that needs no new driver is added with data files and one entry.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .reference.mesh import box_connectivity, perturbed_vertices

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# the top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ceedpetscsolid_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # the spec's end-to-end entries of this cell
    per_layer: list           # the spec's per-layer entries of this cell


@dataclass
class Run:
    """One run of a cell: what the driver's command line gives, the
    process's start, and the device (CUDA; the CPU tests pass "cpu")."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The workload `name` of root/BENCHMARK.json and its files (KeyError
    if there is no such workload)."""
    spec = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work)}")
    w = work[name]
    config = load_json(here / "configs" / f"{w['config']}.json")
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = load_json(here / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layer)


def reader(metric: str, here: Path = HERE):
    """The `read(run)` function of benchmark/metrics/<metric>.py."""
    import importlib.util

    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind(name: str):
    """The driver module benchmark/kinds/<name>.py."""
    import importlib

    return importlib.import_module(f"benchmark.kinds.{name}")


# -- inputs ------------------------------------------------------------------
def seeded_mesh(config: dict, seed: int):
    """(faces, vertices) of the configuration's box, moved by the seed."""
    faces = tuple(int(f) for f in config["box_faces"])
    return faces, perturbed_vertices(faces, seed, config["perturbation"])


def request_seed(seed: int, i: int) -> int:
    """The generator seed of request i of a run (fits torch's 64 bits)."""
    return (int(seed) * 1_000_003 + 7919 * int(i) + 1) % (2 ** 63)


def port_mesh(faces, vertices):
    """The program's HexMesh of the seeded box: its own box numbering and
    face sets, the benchmark's vertices."""
    from ceedpetscsolid_tpu_torch.mesh.box import box_mesh

    mesh = box_mesh(faces)
    if not np.array_equal(mesh.connectivity, box_connectivity(faces)):
        raise RuntimeError("the program's box numbering is not the "
                           "benchmark's")
    mesh.vertices = np.asarray(vertices, dtype=np.float64)
    return mesh


def port_config(config: dict, device, **overrides):
    """The program's Config of a configuration file."""
    import torch

    from ceedpetscsolid_tpu_torch.problem import Config

    kw = dict(problem=config["problem"], degree=config["degree"],
              qextra=config["qextra"], nu=config["nu"], E=config["E"],
              test_mode=config["test_mode"],
              box_faces=tuple(config["box_faces"]),
              num_increments=config["num_increments"],
              multigrid=config["multigrid"],
              level_quadrature=config["level_quadrature"],
              coarse_solve=config["coarse_solve"],
              smooth_its=config["smooth_its"], ksp_rtol=config["ksp_rtol"],
              dtype=getattr(torch, config["dtype"]), device=device)
    kw.update(overrides)
    cfg = Config(**kw)
    cfg.newton.rtol = config["newton_rtol"]
    return cfg


# -- the run's record ----------------------------------------------------------
def process_start_epoch() -> float:
    """The epoch second at which this process started (Linux /proc)."""
    import time

    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    started_since_boot = int(fields[19]) / ticks
    return time.time() - (uptime - started_since_boot)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that a run may not hold, compared
    whole (the program's name only begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit_w(index: int = 0):
    """The card's power limit in W from nvidia-smi, None where unreadable."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def reservoir(rng, k: int):
    """Keep-or-not decisions of reservoir sampling of size k: feed(i)
    returns the slot (0..k-1) request i takes, or None."""
    def feed(i: int):
        if i < k:
            return i
        j = int(rng.integers(0, i + 1))
        return j if j < k else None
    return feed
