"""The least time the card could take for one hyperFS Jacobian action
(J.v) of the operator as the reference's libCEED operator defines it,
from shapes alone, whatever implements it.

Bytes, each counted once: the input and the output L-vector (3 words a
node each), the restriction's indices (4 bytes, P^3 an element), the
stored quadrature data (10 words a point) and the stored linearization
state gradu (9 words a point). No intermediate E-vector is counted: an
implementation that writes one moves more than this, and its share says
so.

Operations: the sum-factorized contractions (an FMA counts 2) of the
gradient and its adjoint, and the pointwise linearized physics, 616 a
point (the count of the program's fused apply, csrc/fused_apply.cu, as it
stands; copied here, not read from the program).

Peaks: NVIDIA's published H100 SXM figures, HBM3 3.35 TB/s and, outside
the tensor cores, 67 TFLOP/s in float32 and 34 TFLOP/s in float64. They
assume the card's 700 W limit; the run records the card's own limit.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"float32": 67e12, "float64": 34e12}
WORD = {"float32": 4, "float64": 8}
JV_POINT_FLOPS = 616


def jv_bytes(P: int, Q: int, nelem: int, num_nodes: int, dtype: str) -> int:
    points = nelem * Q ** 3
    return (WORD[dtype] * (2 * 3 * num_nodes + (10 + 9) * points)
            + 4 * nelem * P ** 3)


def jv_flops(P: int, Q: int, nelem: int) -> int:
    forward = 3 * P * P * Q * 2 * P + 3 * P * Q * Q * 3 * P + Q ** 3 * 9 * P
    adjoint = Q ** 3 * 9 * P + 3 * P * P * Q * 3 * Q + 3 * P ** 3 * 2 * Q
    return nelem * (2 * (forward + adjoint) + Q ** 3 * JV_POINT_FLOPS)


def jv_bound_s(P: int, Q: int, nelem: int, num_nodes: int,
               dtype: str) -> float:
    """max(bytes / bandwidth, operations / peak) in seconds."""
    return max(jv_bytes(P, Q, nelem, num_nodes, dtype) / H100_BYTES_PER_S,
               jv_flops(P, Q, nelem) / H100_FLOPS[dtype])
