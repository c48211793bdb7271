"""Phase-scoped timing (the PetscLogStage analog; reference
elasticity.c:128-131, 230-233, 381-384, 627-630 register the stages "DM and
Vector Setup", "libCEED Setup", "SNES Setup", "SNES Solve", surfaced by
-log_view).

Each ElasticityProblem and each DistributedProblem owns a StageLog on its
device (which has no default: a log that forgot it would time nothing on
the card). Stage times are host wall clock; a stage that ends with device
work still queued is synchronised first (`sync`), so the time includes that
work. `cuda_time_ms` times one call on
the card with CUDA events (kernel and operator timings), the host's enqueue
included; `cuda_device_ms` times the device's work alone.
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


def _sleep_ms_per_mcycle() -> float:
    """Device time of torch.cuda._sleep(10**6), in ms."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10**6)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def cuda_device_ms(fn, reps: int = 20, inner: int = 10,
                   warmup: int = 3) -> float:
    """Median device time of one fn() in ms, without the host's enqueue.

    Each sample brackets `inner` calls with CUDA events, enqueued behind a
    torch.cuda._sleep that holds the stream until the host has enqueued
    them all, so the events see only the device's work (and the gaps the
    device itself leaves between kernels). The sleep starts at four times
    the measured enqueue time plus 1 ms; a sample whose enqueue outlasted
    it (a host stall) is dropped and the sleep doubled, at most 8 times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int((4 * enqueue_ms + 1.0) / _sleep_ms_per_mcycle() * 1e6)
    ts, stalls = [], 0
    while len(ts) < reps:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if s.elapsed_time(a) > host_ms:
            ts.append(a.elapsed_time(b) / inner)
            continue
        stalls += 1
        if stalls > 8:
            raise RuntimeError(
                f"cuda_device_ms: the enqueue ({host_ms:.3f} ms) outlasted "
                f"the stream-holding sleep ({s.elapsed_time(a):.3f} ms) "
                f"{stalls} times")
        cycles *= 2
    return statistics.median(ts)


@dataclass
class StageLog:
    """Accumulating named phase timers on `device`."""

    device: torch.device
    stages: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Count `seconds` under `name`, as one more call of the stage."""
        if name not in self.stages:
            self.stages[name] = [0.0, 0]
            self._order.append(name)
        self.stages[name][0] += seconds
        self.stages[name][1] += 1

    def seconds(self) -> dict:
        """{stage: seconds so far}, in the order the stages first ran."""
        return {name: self.stages[name][0] for name in self._order}

    def report(self) -> str:
        """-log_view style summary."""
        lines = ["Stage                          Time (s)   Count"]
        for name in self._order:
            t, c = self.stages[name]
            lines.append(f"{name:30s} {t:9.4f}   {c:5d}")
        return "\n".join(lines)
