"""Rank 0's card's idle share of the traced window of the distributed
solve: 1 - the union of the profiler's device intervals over the
window's wall, in % (device_idle.solve's reader)."""

from benchmark import common

read = common.reader("device_idle.solve")
