"""Seconds of the AMG refreshes a distributed solve on rank 0
(parallel/driver.py refresh_amg: the p = 1 values gathered from every
rank, then solve/amg.py's device refresh, or the native setup at the
first build): the program's pc/amg/* spans, the window's mean
(amg_refresh_s.solve's arithmetic)."""

from benchmark.dist_records import one_card

read = one_card("amg_refresh_s.solve")
