"""The benchmark's plain reference: numpy and plain torch only.

Nothing here imports the measured package (`ceedpetscsolid_tpu_torch`),
the JAX package or JAX. The mesh, the basis, the geometry, the hyperFS
physics and the manufactured solution are written out again from their
definitions, so that the comparison that decides `correct` shares no code
with the program it judges.
"""
