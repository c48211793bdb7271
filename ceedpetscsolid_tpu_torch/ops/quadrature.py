"""1D quadrature rules: Gauss-Legendre and Gauss-Lobatto-Legendre.

Copy of ceedpetscsolid_tpu/ops/quadrature.py (numpy only; see
mesh/fespace.py for why the port copies instead of importing).

Reference parity: libCEED's CEED_GAUSS / CEED_GAUSS_LOBATTO modes used by
CeedBasisCreateTensorH1Lagrange (reference src/setuplibceed.c:335-348).
Points live on [-1, 1]; weights integrate polynomials exactly up to degree
2n-1 (Gauss) / 2n-3 (Lobatto).

Computed in numpy float64 at setup time (never on the device hot path).
"""

from __future__ import annotations

import numpy as np


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [-1, 1] -> (points, weights)."""
    if n < 1:
        raise ValueError("need at least one quadrature point")
    pts, wts = np.polynomial.legendre.leggauss(n)
    return pts.astype(np.float64), wts.astype(np.float64)


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto-Legendre rule on [-1, 1] -> (points, weights).

    Interior points are the roots of P'_{n-1}; found by Newton iteration from
    Chebyshev-Lobatto initial guesses (standard spectral-methods recipe).
    """
    if n < 2:
        if n == 1:
            # Degenerate single-node "rule" (collocation midpoint).
            return np.zeros(1), np.full(1, 2.0)
        raise ValueError("Gauss-Lobatto needs at least 2 points")
    # Chebyshev-Lobatto initial guess
    x = np.cos(np.pi * np.arange(n) / (n - 1))[::-1].copy()
    P = np.zeros((n, n))
    x_old = np.full_like(x, 2.0)
    while np.max(np.abs(x - x_old)) > 1e-15:
        x_old = x.copy()
        P[:, 0] = 1.0
        P[:, 1] = x
        for k in range(2, n):
            P[:, k] = ((2 * k - 1) * x * P[:, k - 1] - (k - 1) * P[:, k - 2]) / k
        # Newton step for roots of (1-x^2) P'_{n-1}(x)
        x = x_old - (x * P[:, n - 1] - P[:, n - 2]) / (n * P[:, n - 1])
    w = 2.0 / (n * (n - 1) * P[:, n - 1] ** 2)
    x[0], x[-1] = -1.0, 1.0
    return x, w
