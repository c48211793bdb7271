"""The exchanges' share of the distributed solve (parallel/dist.py: the
halo all_to_alls, CG's all_reduces, the AMG's all_gathers): rank 0's
waits on them over its solve spans, the window's untraced requests, in
%. A wait is the stream's, on the device's clock, where the program timed
it so (NCCL: device ms under the span's name), else the host's
dist/<kind>/wait span (gloo)."""

from benchmark.readers import untraced

KINDS = ("all_to_all", "all_reduce", "all_gather")


def _wait_s(rec) -> float:
    total = 0.0
    for kind in KINDS:
        name = f"dist/{kind}/wait"
        ms = rec["stream_ms"].get(name)
        total += ms * 1e-3 if ms is not None else rec["seconds"].get(name,
                                                                    0.0)
    return total


def read(run):
    recs = untraced([q for q in run["records"] if q.get("program")])
    total = sum(q["program"]["seconds"]["solve"] for q in recs)
    return (100.0 * sum(_wait_s(q["program"]) for q in recs) / total
            if total else None)
