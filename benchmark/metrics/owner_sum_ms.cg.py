"""Device ms of the restriction's owner-sum a CG iteration
(ops/restriction.py Restriction.scatter_add, after each fused J.v): the
CUDA event time of the program's op/owner_sum spans over the traced
requests, over their CG iterations (on the CPU, the spans' host time)."""

from benchmark.spans import profiled_requests


def read(run):
    recs = profiled_requests("linear_solve")
    if not recs:
        return None
    its = sum(r["counts"].get("cg.iterations", 0) for r in recs)
    ms = sum(r["stream_ms"].get("op/owner_sum", 0.0) for r in recs)
    return ms / its if its and ms else None
