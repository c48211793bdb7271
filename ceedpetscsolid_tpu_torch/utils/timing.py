"""Phase-scoped timing (the PetscLogStage analog; reference
elasticity.c:128-131, 230-233, 381-384, 627-630 register the stages "DM and
Vector Setup", "libCEED Setup", "SNES Setup", "SNES Solve", surfaced by
-log_view).

Each ElasticityProblem owns its StageLog. Stage times are host wall clock;
a stage that ends with device work still queued is synchronised first
(`sync`), so the time includes that work. `cuda_time_ms` times one call on
the card with CUDA events (kernel and operator timings).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field

import torch


def sync(device: torch.device) -> None:
    """Wait for queued work on `device` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


@dataclass
class StageLog:
    """Accumulating named phase timers."""

    device: torch.device = torch.device("cpu")
    stages: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            dt = time.perf_counter() - t0
            if name not in self.stages:
                self.stages[name] = [0.0, 0]
                self._order.append(name)
            self.stages[name][0] += dt
            self.stages[name][1] += 1

    def report(self) -> str:
        """-log_view style summary."""
        lines = ["Stage                          Time (s)   Count"]
        for name in self._order:
            t, c = self.stages[name]
            lines.append(f"{name:30s} {t:9.4f}   {c:5d}")
        return "\n".join(lines)
