"""Preconditioner set-up's share of the distributed solve
(parallel/driver.py refresh_amg and pc_setup: the p = 1 element matrices
and their all-gather, the AMG refresh, the level diagonals, the
Chebyshev eigenvalue estimates): rank 0's pc spans over its solve spans,
the window's untraced requests, in % (pc_share.solve's arithmetic)."""

from benchmark.dist_records import one_card

read = one_card("pc_share.solve")
