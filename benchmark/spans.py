"""The program's own spans and counters, as the per-layer readers of
benchmark/metrics/ take them: the request records that
ceedpetscsolid_tpu_torch/utils/timing.py keeps in the process (a request
is a whole solve, "solve", or a linear solve called on its own,
"linear_solve"; each record holds seconds by span name, counts by counter
and, for a request run under the profiler, device ms by span name). A
program without that store gives None, and so does its reader."""

from __future__ import annotations


def _records(name: str):
    try:
        from ceedpetscsolid_tpu_torch.utils.timing import records
    except ImportError:
        return None
    return [r for r in records() if r["name"] == name]


def window_requests(name: str):
    """The window's untraced requests named `name`: those recorded after
    the last profiled one (a traced run profiles the window's first
    requests, and the warm ones come before them), else the profiled ones
    (every one where none was profiled); None where there are none."""
    recs = _records(name)
    if not recs:
        return None
    last = max((i for i, r in enumerate(recs) if r["profiled"]), default=-1)
    return recs[last + 1:] or profiled_requests(name)


def profiled_requests(name: str):
    """The last unbroken run of profiled requests named `name` (the
    traced requests of this window), or None."""
    recs = _records(name) or []
    out = []
    for r in reversed(recs):
        if r["profiled"]:
            out.append(r)
        elif out:
            break
    return out[::-1] or None
