"""Wall ms a CG iteration with its V-cycle in the distributed solve
(solve/cg.py with parallel/driver.py's V-cycle, the halo exchanges and
CG's all-reduces): rank 0's solve less pc spans over its CG iterations,
the window's untraced requests (cg_iter_ms.solve's arithmetic)."""

from benchmark.dist_records import one_card

read = one_card("cg_iter_ms.solve")
