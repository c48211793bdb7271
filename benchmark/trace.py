"""The device trace of a traced run, reduced to what the per-layer readers
and the result's `breakdown` need.

`Tracer` runs torch.profiler (host and CUDA activity) over part of the
measured window and reduces its events to a plain, picklable dict:

  window_s     the traced window's wall (the device synchronised at its
               end)
  busy_s       the union of the device's operation intervals inside it
  kernels      {name: [launches, device seconds]} of every device operation
  launches     the kernel launches (device operations other than memcpy and
               memset)
  device_ops   the 10 device operations with the most time, [name, s]
               (names shortened by `short`)
  idle_gaps    the device's idle time by what the host was running in the
               middle of each gap (the innermost host operation there),
               the 10 largest, [name, s]
  requests     how many requests the trace covers

`kernel_family` is the classifier of the program's utils/profile_solve.py
rewritten from what it computes: the fused element apply's kernels are
cps::<body>_kernel<physics, jacobian, P, Q, T> (the generic tile's have no
P, Q in the name).
"""

from __future__ import annotations

import bisect
import re

FUSED = re.compile(
    r"cps::\w+_kernel<(\d+), (true|false), (?:(\d+), (\d+), )?\w+(?:, \d+)?>")
COPIES = ("Memcpy", "Memset")
TOP = 10
NAME_CHARS = 120            # a breakdown entry's name, cut to this length


def short(name: str) -> str:
    """A device operation's name for the breakdown: no return type, no
    argument list, at most NAME_CHARS characters."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += (name[i] == ")") - (name[i] == "(")
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:NAME_CHARS]


def kernel_family(name: str):
    """("jv" | "residual", physics id, P, Q) of a fused-apply kernel (P and
    Q None for the generic tile), or None for any other operation."""
    m = FUSED.search(name)
    if not m:
        return None
    mode = "jv" if m.group(2) == "true" else "residual"
    pq = (int(m.group(3)), int(m.group(4))) if m.group(3) else (None, None)
    return (mode, int(m.group(1)), *pq)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, t0: float, t1: float):
    """The gaps of [t0, t1] that no interval covers, as (start, end)."""
    gaps, at = [], t0
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        gaps.append((at, t1))
    return [(s, e) for s, e in gaps if e > s]


def _host_label(host, starts, t: float) -> str:
    """The innermost host operation running at t (the latest-starting one
    that covers t), looked for among the 256 that started last before t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 257, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host (no operation traced)"


def reduce_events(events, t0: float, t1: float, requests: int) -> dict:
    """events: (is_device, name, start s, end s) -> the summary above."""
    dev, host, kernels = [], [], {}
    for is_dev, name, s, e in events:
        if is_dev:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            dev.append((s, e))
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += e - s
        else:
            host.append((s, e, name))
    host.sort()
    starts = [h[0] for h in host]
    gaps = {}
    for s, e in idle_gaps(dev, t0, t1):
        label = _host_label(host, starts, 0.5 * (s + e))
        gaps[label] = gaps.get(label, 0.0) + (e - s)
    launches = sum(n for name, (n, _) in kernels.items()
                   if not name.startswith(COPIES))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"window_s": t1 - t0, "busy_s": union_length(dev),
            "kernels": kernels, "launches": launches, "requests": requests,
            "device_ops": [[short(n), v[1]] for n, v in top],
            "idle_gaps": sorted(([n, v] for n, v in gaps.items()),
                                key=lambda kv: -kv[1])[:TOP]}


WINDOW = "benchmark traced window"


class Tracer:
    """torch.profiler over part of a window on one device: start(), the
    traced requests, stop(requests) -> the summary dict. The traced window
    is a host span of its own (WINDOW), so that its ends are on the
    trace's own clock."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()

    def stop(self, requests: int) -> dict:
        import torch

        self._sync()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        events, window = [], None
        for ev in self._prof.profiler.kineto_results.events():
            is_dev = ev.device_type() == torch.autograd.DeviceType.CUDA
            annotation = getattr(ev, "is_user_annotation", None)
            if is_dev and (ev.name() == WINDOW
                           or (annotation is not None and annotation())):
                continue        # a span drawn on the device's timeline
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            if not is_dev and ev.name() == WINDOW:
                window = (s, e)
            else:
                events.append((is_dev, ev.name(), s, e))
        self._prof = self._span = None
        if window is None:
            raise RuntimeError("the profiler lost the traced window's span")
        summary = reduce_events(events, *window, requests)
        if self.device.type == "cuda" and summary["busy_s"] <= 0.0:
            raise RuntimeError("the profiler saw no device operation in the "
                               "traced window")
        return summary
