"""Arithmetic that several per-layer readers share (benchmark/metrics/)."""

from __future__ import annotations

from .reference.roofline import jv_bound_s
from .trace import kernel_family


def untraced(records):
    """The requests that ran without the profiler, or all where every one
    was traced: the program's own spans read the untraced ones, since the
    profiler slows the requests it traces."""
    plain = [r for r in records if not r.get("traced")]
    return plain or records


def idle_share(run):
    """1 - busy / window of the traced window, in %; None untraced."""
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def jv_roofline(run):
    """Sum over the traced fused J.v launches of the bound of each (its
    (P, Q) shape from run["shapes"]) over their summed device time, in %.
    None when the trace holds no fused J.v of a known shape."""
    t = run["trace"]
    if not t:
        return None
    shapes = run["shapes"]["jv"]
    bound = spent = 0.0
    for name, (n, secs) in t["kernels"].items():
        fam = kernel_family(name)
        if fam is None or fam[0] != "jv" or fam[2] is None:
            continue
        shape = shapes.get(f"{fam[2]},{fam[3]}")
        if shape is None:
            continue
        bound += n * jv_bound_s(fam[2], fam[3], shape["nelem"],
                                shape["nodes"], run["shapes"]["dtype"])
        spent += secs
    return 100.0 * bound / spent if spent > 0 else None
