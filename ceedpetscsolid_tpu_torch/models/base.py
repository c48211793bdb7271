"""Common physics-kernel plumbing over torch tensors.

Port of ceedpetscsolid_tpu/models/base.py. Every 3x3 tensor field is a
`Mat3`: a tuple of nine equal-shaped "planes" (typically (nelem, Q3)), so
the 3x3 algebra unrolls into elementwise ops over long batch planes.

Conventions (matching qfunctions/*.h of the reference):

  du_ref[c, m]  : d u_c / d X_m  (reference-coordinate gradient planes)
  qdata[0]      : w * detJ
  qdata[1+3m+k] : dXdx[m, k] = d X_m / d x_k
  dv_ref[c, k]  : weighted test-function gradient planes

Physical gradient: gradu[c, k] = sum_m du_ref[c, m] dXdx[m, k]
Output weighting:  dv_ref[c, k] = sum_m sigma[c, m] dXdx[k, m] * wdetJ

Under the profiler the 3x3 products are spans (qf/<name>,
utils/timing.fine): each is tens of elementwise launches, so a trace can
name the device's idle time inside a pointwise function by them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils.timing import fine


@dataclass(frozen=True)
class Physics:
    """Material parameters (reference elasticity.h:33-36)."""

    nu: float   # Poisson's ratio
    E: float    # Young's modulus (already scaled to model units)

    @property
    def two_mu(self) -> float:
        return self.E / (1 + self.nu)

    @property
    def mu(self) -> float:
        return self.two_mu / 2

    @property
    def bulk(self) -> float:
        return self.E / (3 * (1 - 2 * self.nu))

    @property
    def lam(self) -> float:
        # lambda = (3K - 2mu)/3, as in linElas.h:302-305
        return (3 * self.bulk - self.two_mu) / 3


class Mat3:
    """A 3x3 tensor of batch planes (row-major tuple of nine tensors)."""

    __slots__ = ("m",)

    def __init__(self, planes):
        m = tuple(planes)
        if len(m) != 9:
            raise ValueError(f"Mat3 needs 9 planes, got {len(m)}")
        self.m = m

    @staticmethod
    def from_rows(rows):
        """rows: 3x3 nested list of planes."""
        return Mat3([rows[i][j] for i in range(3) for j in range(3)])

    @staticmethod
    def from_array(a: torch.Tensor) -> "Mat3":
        """(3, 3, *batch) tensor -> Mat3 of views."""
        return Mat3([a[i, j] for i in range(3) for j in range(3)])

    def to_array(self) -> torch.Tensor:
        """Mat3 -> (3, 3, *batch) tensor."""
        return torch.stack(self.m).reshape((3, 3) + self.m[0].shape)

    def __getitem__(self, ij):
        i, j = ij
        return self.m[3 * i + j]

    @property
    def T(self) -> "Mat3":
        return Mat3([self.m[3 * j + i] for i in range(3) for j in range(3)])

    def __add__(self, other):
        return Mat3([a + b for a, b in zip(self.m, other.m)])

    def __sub__(self, other):
        return Mat3([a - b for a, b in zip(self.m, other.m)])

    def __mul__(self, s):
        """Scalar or batch-plane broadcast multiply."""
        return Mat3([a * s for a in self.m])

    __rmul__ = __mul__

    def __truediv__(self, s):
        return Mat3([a / s for a in self.m])


def mat_mul(a: Mat3, b: Mat3) -> Mat3:
    """(A B)[j, k] = sum_m A[j, m] B[m, k]."""
    with fine("qf/mat_mul"):
        return Mat3.from_rows(
            [[a[j, 0] * b[0, k] + a[j, 1] * b[1, k] + a[j, 2] * b[2, k]
              for k in range(3)] for j in range(3)]
        )


def mat_mul_T2(a: Mat3, b: Mat3) -> Mat3:
    """(A B^T)[j, k] = sum_m A[j, m] B[k, m]."""
    with fine("qf/mat_mul_T2"):
        return Mat3.from_rows(
            [[a[j, 0] * b[k, 0] + a[j, 1] * b[k, 1] + a[j, 2] * b[k, 2]
              for k in range(3)] for j in range(3)]
        )


def mat_T1_mul(a: Mat3, b: Mat3) -> Mat3:
    """(A^T B)[j, k] = sum_n A[n, j] B[n, k]."""
    with fine("qf/mat_T1_mul"):
        return Mat3.from_rows(
            [[a[0, j] * b[0, k] + a[1, j] * b[1, k] + a[2, j] * b[2, k]
              for k in range(3)] for j in range(3)]
        )


def mat_trace(a: Mat3):
    return a[0, 0] + a[1, 1] + a[2, 2]


def mat_ddot(a: Mat3, b: Mat3):
    """A : B = sum_jk A[j,k] B[j,k]."""
    with fine("qf/ddot"):
        acc = a[0, 0] * b[0, 0]
        for j in range(3):
            for k in range(3):
                if j or k:
                    acc = acc + a[j, k] * b[j, k]
        return acc


def mat_eye_plus(a: Mat3) -> Mat3:
    """I + A."""
    m = list(a.m)
    for d in range(3):
        m[4 * d] = m[4 * d] + 1.0
    return Mat3(m)


def mat_scale_eye_plus(s, a: Mat3) -> Mat3:
    """s*I + A (s is a batch plane or a scalar)."""
    m = list(a.m)
    for d in range(3):
        m[4 * d] = m[4 * d] + s
    return Mat3(m)


def sym(g: Mat3) -> Mat3:
    """Symmetric part: 1/2 (g + g^T)."""
    return Mat3.from_rows(
        [[0.5 * (g[i, j] + g[j, i]) for j in range(3)] for i in range(3)])


def unpack_qdata(qdata: torch.Tensor):
    """qdata (10, *batch) -> (wdetJ plane, dXdx Mat3 of views)."""
    return qdata[0], Mat3([qdata[1 + k] for k in range(9)])


def ref_to_phys_grad(du_ref: Mat3, dXdx: Mat3) -> Mat3:
    """gradu[c, k] = sum_m du_ref[c, m] * dXdx[m, k]."""
    return mat_mul(du_ref, dXdx)


def weight_test_grad(sigma: Mat3, dXdx: Mat3, wdetJ) -> Mat3:
    """dv_ref[c, k] = sum_m sigma[c, m] dXdx[k, m] * wdetJ."""
    with fine("qf/test_grad"):
        return mat_mul_T2(sigma, dXdx) * wdetJ


def log1p_series(x: torch.Tensor) -> torch.Tensor:
    """log1p series of the reference (hyperSS.h:43-55).

    Accurate to ~1e-7 on sqrt(2)/2 < 1+x < sqrt(2), machine precision near 0.
    Kept for comparable results with the reference kernels.
    """
    y = x / (2.0 + x)
    y2 = y * y
    s = y
    y = y * y2
    s = s + y / 3
    y = y * y2
    s = s + y / 5
    y = y * y2
    s = s + y / 7
    return 2 * s


_SQRT2 = math.sqrt(2.0)
_LN2 = math.log(2.0)


def log1p_series_shifted(x: torch.Tensor) -> torch.Tensor:
    """Range-extended series (hyperFS.h:45-67): valid 0.35 < 1+x < 2.83."""
    left = _SQRT2 / 2 - 1
    right = _SQRT2 - 1
    shift_down = x < left
    shift_up = x > right
    x_adj = torch.where(shift_down, 1 + 2 * x,
                        torch.where(shift_up, (x - 1) / 2, x))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    base = torch.where(shift_down, zero - _LN2 / 2,
                       torch.where(shift_up, zero + _LN2 / 2, zero))
    return 2 * base + log1p_series(x_adj)
