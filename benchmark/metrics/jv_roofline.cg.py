"""The fused J.v's share of its roofline (ops/fused_apply.py,
csrc/fused_apply.cu): the bound of each traced launch from its shape
(benchmark/reference/roofline.py) over its profiler device time, summed
over the traced window, in %."""

from benchmark.readers import jv_roofline


def read(run):
    return jv_roofline(run)
