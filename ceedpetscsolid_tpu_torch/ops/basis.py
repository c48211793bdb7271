"""Tensor-product H1 Lagrange bases (the CeedBasis analog).
Port of ceedpetscsolid_tpu/ops/basis.py.

A `Basis1D` holds the 1D interpolation and differentiation matrices from P
Lagrange nodes at Gauss-Lobatto points (CeedBasisCreateTensorH1Lagrange,
reference src/setuplibceed.c:335-348) to Q evaluation points.

`Basis3D` carries two forms on the target device: the full Kronecker
(Q^3 x P^3) interp and gradient matrices for the plain torch path, and the
1D (Q, P) `B`, `D` matrices that the fused CUDA kernel contracts by sum
factorization.

Index conventions: lattice points are ordered x-fastest, i.e. flat index
n = i + P*(j + P*k) for node (i,j,k); likewise for quadrature points.
Gradient direction d: 0=x, 1=y, 2=z (reference-coordinate derivatives).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import quadrature


def lagrange_matrices(nodes: np.ndarray, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Interp and derivative matrices of the Lagrange basis on `nodes` at `pts`.

    Returns (B, D) with B[q, p] = l_p(x_q) and D[q, p] = l'_p(x_q), in the
    product form of the JAX package (exact at nodes).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    P = nodes.size
    B = np.zeros((pts.size, P))
    D = np.zeros((pts.size, P))
    for qi, x in enumerate(pts):
        for p in range(P):
            val = 1.0
            for m in range(P):
                if m != p:
                    val *= (x - nodes[m]) / (nodes[p] - nodes[m])
            B[qi, p] = val
            acc = 0.0
            for m in range(P):
                if m == p:
                    continue
                term = 1.0 / (nodes[p] - nodes[m])
                for r in range(P):
                    if r in (p, m):
                        continue
                    term *= (x - nodes[r]) / (nodes[p] - nodes[r])
                acc += term
            D[qi, p] = acc
    return B, D


@dataclass(frozen=True)
class Basis1D:
    """1D basis: P Lagrange nodes (Lobatto) -> Q evaluation points."""

    P: int
    Q: int
    nodes: np.ndarray      # (P,) Gauss-Lobatto nodal points on [-1,1]
    qpts: np.ndarray       # (Q,) evaluation points
    qweights: np.ndarray   # (Q,) quadrature weights
    B: np.ndarray          # (Q, P) interp
    D: np.ndarray          # (Q, P) derivative

    @staticmethod
    def create(P: int, Q: int, quad_mode: str = "gauss") -> "Basis1D":
        nodes, _ = (quadrature.gauss_lobatto(P) if P > 1
                    else (np.zeros(1), np.full(1, 2.0)))
        if quad_mode == "gauss":
            qpts, qwts = quadrature.gauss(Q)
        elif quad_mode == "gauss_lobatto":
            qpts, qwts = quadrature.gauss_lobatto(Q)
        else:
            raise ValueError(f"unknown quadrature mode {quad_mode!r}")
        B, D = lagrange_matrices(nodes, qpts)
        return Basis1D(P=P, Q=Q, nodes=nodes, qpts=qpts, qweights=qwts, B=B, D=D)


def _kron3(A2: np.ndarray, A1: np.ndarray, A0: np.ndarray) -> np.ndarray:
    """kron over (z, y, x) with x fastest: out[(qz qy qx), (pz py px)]."""
    return np.kron(A2, np.kron(A1, A0))


@dataclass(frozen=True)
class Basis3D:
    """Tensor-product 3D basis with matrices on the target device.

    Attributes (torch tensors, framework dtype):
      interp   : (Q3, P3)     value interpolation
      grad     : (3, Q3, P3)  reference-coordinate gradients
      qweights : (Q3,)        tensor quadrature weights
      B, D     : (Q, P)       1D interp / derivative (fused kernel operands)
    """

    b1: Basis1D
    interp: torch.Tensor
    grad: torch.Tensor
    qweights: torch.Tensor
    B: torch.Tensor
    D: torch.Tensor

    @property
    def P(self) -> int:
        return self.b1.P

    @property
    def Q(self) -> int:
        return self.b1.Q

    @property
    def P3(self) -> int:
        return self.b1.P ** 3

    @property
    def Q3(self) -> int:
        return self.b1.Q ** 3

    @staticmethod
    def create(P: int, Q: int, quad_mode: str = "gauss",
               dtype=torch.float64, *, device) -> "Basis3D":
        b1 = Basis1D.create(P, Q, quad_mode)
        B, D = b1.B, b1.D
        grad = np.stack([_kron3(B, B, D),    # d/dX0 (x fastest)
                         _kron3(B, D, B),    # d/dX1
                         _kron3(D, B, B)])   # d/dX2
        w1 = b1.qweights
        qw = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :]).reshape(-1)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        return Basis3D(b1=b1, interp=t(_kron3(B, B, B)), grad=t(grad),
                       qweights=t(qw), B=t(B), D=t(D))

    # ------------------------------------------------------------------
    # Component-major application: ue (ncomp, nelem, P3); gradients are
    # (ncomp, 3, nelem, Q3) planes.
    # ------------------------------------------------------------------
    def apply_interp(self, ue: torch.Tensor) -> torch.Tensor:
        """(ncomp, nelem, P3) -> (ncomp, nelem, Q3)."""
        return torch.einsum("qp,cep->ceq", self.interp, ue)

    def apply_grad(self, ue: torch.Tensor) -> torch.Tensor:
        """(ncomp, nelem, P3) -> (ncomp, 3, nelem, Q3) reference-coord grads."""
        return torch.einsum("dqp,cep->cdeq", self.grad, ue)

    def apply_interp_T(self, vq: torch.Tensor) -> torch.Tensor:
        """(ncomp, nelem, Q3) -> (ncomp, nelem, P3)."""
        return torch.einsum("qp,ceq->cep", self.interp, vq)

    def apply_grad_T(self, dv: torch.Tensor) -> torch.Tensor:
        """(ncomp, 3, nelem, Q3) -> (ncomp, nelem, P3)."""
        return torch.einsum("dqp,cdeq->cep", self.grad, dv)
