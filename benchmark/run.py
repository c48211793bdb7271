"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell is found by name in BENCHMARK.json;
its configuration, traffic mix and limits are data files under benchmark/,
its driver is benchmark/kinds/<kind>.py, and each per-layer metric has a
reader benchmark/metrics/<metric>.py (see common.py).

Needs as many CUDA devices as the cell asks for: without them it exits 2
and prints no result; there is no CPU fallback. With --trace 0 the line
carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics, device busy and window seconds, and the trace's breakdown. The
numbers compared with the reference are printed beside their limits as the
last lines of standard error and under "checks", the line's last key. A
process that holds jax, jaxlib, flax or the JAX package once the window has
closed exits 3 and prints no result.

The program's kernel libraries are built into build/ inside the checkout
(its own rule); torch's and Triton's caches are pointed into
build/bench_cache/ there too, at fixed paths.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from . import common


def _caches():
    cache = common.ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def result_line(cell: common.Cell, out: dict, trace: bool, device: dict,
                read=common.reader) -> dict:
    """The result's JSON object from a driver's outcome."""
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = (out["setup_s"] if m["name"] == "setup_s"
                 else out["e2e"][m["name"]])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = read(m["name"])(out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(lim is not None and math.isfinite(v) and v <= lim
                  for v, lim in out["checks"].values())
    line = {"correct": bool(correct), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and out["trace"] is not None:
        t = out["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out["checks"].items()}
    return line


def main(argv=None) -> int:
    t_start = common.process_start_epoch()
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _caches()
    cell = common.load_cell(a.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    kind = common.kind(cell.traffic["kind"])
    run = common.Run(cell=cell, seed=a.seed, seconds=a.seconds,
                     trace=bool(a.trace), t_start=t_start)
    out = kind.run(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit_w": common.power_limit_w(0)}
    line = result_line(cell, out, bool(a.trace), device)
    bad = common.forbidden_modules()
    if bad:
        print(f"the run's process holds {bad}", file=sys.stderr)
        return 3
    walls = sorted(r["wall_s"] for r in out["records"] if "wall_s" in r)
    if walls:
        print(f"requests {len(walls)}: wall s min {walls[0]!r} median "
              f"{walls[len(walls) // 2]!r} max {walls[-1]!r}",
              file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
