"""The fused J.v's share of its roofline on rank 0 of the distributed
solve (ops/fused_apply.py, csrc/fused_apply.cu on the rank's interior
and boundary batches, every p-MG level at the fine quadrature): the
bound of each traced launch from its batch's shape
(benchmark/reference/roofline.py; a level's launches alternate between
its two batches) over its profiler device time, summed over the traced
window, in %."""

from benchmark.reference.roofline import jv_bound_s
from benchmark.trace import kernel_family


def read(run):
    t = run["trace"]
    if not t:
        return None
    shapes, dtype = run["shapes"]["jv"], run["shapes"]["dtype"]
    bound = spent = 0.0
    for name, (n, secs) in t["kernels"].items():
        fam = kernel_family(name)
        if fam is None or fam[0] != "jv" or fam[2] is None:
            continue
        batches = shapes.get(f"{fam[2]},{fam[3]}")
        if not batches:
            continue
        bound += n / len(batches) * sum(
            jv_bound_s(fam[2], fam[3], b["nelem"], b["nodes"], dtype)
            for b in batches)
        spent += secs
    return 100.0 * bound / spent if spent > 0 else None
