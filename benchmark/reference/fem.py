"""Plain reference of the hyperFS operator on a box mesh of degree-p
hexahedra (the reference mini-app's -problem hyperFS -test, elasticity.c:36,
cloptions.c:185-187).

Written from the definitions, with nothing taken from the program:

  * nodes: degree-p Lagrange nodes at the Gauss-Lobatto points of each
    element, numbered on the global lattice (I, J, K) -> I + Nx (J + Ny K),
    Nx = p nx + 1; node coordinates by the trilinear map of the element's
    vertices (the reference's 2-point coordinate basis);
  * quadrature: Q = p + 1 Gauss points a direction; geometry from the
    trilinear map: w detJ and dX/dx at each point;
  * physics: Neo-Hookean at finite strain in total Lagrangian form,
    S = lambda log(J) C^-1 + mu C^-1 (C - I), P = F S, with det(C) - 1
    expanded without cancellation and log(J) = log1p(det(C) - 1) / 2 (the
    stable form of qfunctions/hyperFS.h); its exact linearization
    dP = grad(du) S + F dS, dS = lambda (C^-1 : dE) C^-1
    - 2 (lambda log J - mu) C^-1 dE C^-1;
  * forcing: the body force of manufacturedForce.h, copied, integrated
    against the test functions;
  * boundary: u* on every boundary node (the -test mode's BCMMS).

Element work runs in blocks of elements, so that the reference fits beside
whatever else is on the device. Vectors are (3, N) component-major, as the
program's are.

`precision` is "float64" or "tf32": float32 with every basis contraction
taken as a TF32 tensor core takes it, both operands rounded to 10 mantissa
bits and the products summed in float32. "tf32" is the control: the step
below the configurations' float32 with TF32 off. The rounding is explicit,
and a product of two such operands is exact in float32, so neither
precision depends on torch's process-wide TF32 switches: the reference
reads and sets none of them.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import box_connectivity

# the -test mode's manufactured solution, component c = prod over axes d of
# f(a t) with f in (exp, sin, cos), divided by 1e8 (manufacturedTrue.h)
MMS_FACTORS = ((("exp", 2), ("sin", 3), ("cos", 4)),
               (("cos", 2), ("exp", 3), ("sin", 4)),
               (("sin", 2), ("cos", 3), ("exp", 4)))
MMS_SCALE = 1e-8


def gauss_lobatto(n: int) -> np.ndarray:
    """The n Gauss-Lobatto-Legendre points on [-1, 1]."""
    inner = np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
    return np.concatenate([[-1.0], np.sort(inner.real), [1.0]])


def lagrange(nodes: np.ndarray, pts: np.ndarray):
    """(B, D): B[q, j] = l_j(pts[q]), D[q, j] = l_j'(pts[q]) for the
    Lagrange polynomials on `nodes`."""
    n = nodes.size
    B = np.ones((pts.size, n))
    D = np.zeros((pts.size, n))
    for j in range(n):
        others = [m for m in range(n) if m != j]
        for m in others:
            B[:, j] *= (pts - nodes[m]) / (nodes[j] - nodes[m])
        for k in others:
            term = np.full(pts.size, 1.0 / (nodes[j] - nodes[k]))
            for m in others:
                if m != k:
                    term *= (pts - nodes[m]) / (nodes[j] - nodes[m])
            D[:, j] += term
    return B, D


def kron3(Az, Ay, Ax) -> np.ndarray:
    """Tensor-product matrix, x fastest in rows and columns."""
    return np.kron(Az, np.kron(Ay, Ax))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with TF32's 10 explicit mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class BoxSpace:
    """The degree-p lattice space of a (perturbed) box mesh."""

    def __init__(self, faces, degree: int, vertices: np.ndarray):
        self.faces = tuple(int(f) for f in faces)
        nx, ny, nz = self.faces
        p = self.degree = int(degree)
        P = self.P = p + 1
        self.dims = (p * nx + 1, p * ny + 1, p * nz + 1)
        Nx, Ny, Nz = self.dims
        self.num_nodes = Nx * Ny * Nz
        self.conn8 = box_connectivity(self.faces)
        self.vertices = np.asarray(vertices, dtype=np.float64)
        if self.vertices.shape != ((nx + 1) * (ny + 1) * (nz + 1), 3):
            raise ValueError("vertices do not match the box's faces")
        self.nelem = self.conn8.shape[0]
        c, b, a = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                              indexing="ij")
        k, j, i = np.meshgrid(np.arange(P), np.arange(P), np.arange(P),
                              indexing="ij")
        gi = p * a.ravel()[:, None] + i.ravel()[None, :]
        gj = p * b.ravel()[:, None] + j.ravel()[None, :]
        gk = p * c.ravel()[:, None] + k.ravel()[None, :]
        self.conn = (gi + Nx * (gj + Ny * gk)).astype(np.int64)
        t = (gauss_lobatto(P) + 1.0) / 2.0
        lin = np.stack([1.0 - t, t], axis=1)              # (P, 2)
        W = kron3(lin, lin, lin)                          # (P^3, 8)
        xe = self.vertices[self.conn8]                    # (e, 8, 3)
        coords = np.empty((self.num_nodes, 3))
        coords[self.conn.ravel()] = np.einsum("la,ead->eld", W,
                                              xe).reshape(-1, 3)
        self.coords = coords
        I, J, K = (self.conn.ravel() % Nx, self.conn.ravel() // Nx % Ny,
                   self.conn.ravel() // (Nx * Ny))
        on = np.zeros(self.num_nodes, dtype=bool)
        on[self.conn.ravel()] = ((I == 0) | (I == Nx - 1) | (J == 0)
                                 | (J == Ny - 1) | (K == 0) | (K == Nz - 1))
        self.boundary = on


def mms_solution(xyz: np.ndarray) -> np.ndarray:
    """(n, 3) points -> (n, 3) manufactured displacement u*."""
    return np.stack([_mms_term(xyz, c) for c in range(3)], axis=1)


def _mms_term(xyz, c: int) -> np.ndarray:
    out = MMS_SCALE * np.ones(xyz.shape[0])
    for d, (kind, a) in enumerate(MMS_FACTORS[c]):
        f = np.exp if kind == "exp" else np.sin if kind == "sin" else np.cos
        out = out * f(a * xyz[:, d])
    return out


def mms_force(xyz: np.ndarray, E: float, nu: float) -> np.ndarray:
    """(n, 3) points -> (n, 3) the -test mode's body force: the expression
    of the reference's qfunctions/manufacturedForce.h:62-101, copied as it
    stands (it is not exactly -div sigma(u*) under linear elasticity, and
    the reference mini-app solves with this one)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    den = (nu * 2.0 - 1.0) * (nu + 1.0)
    sin, cos, exp = np.sin, np.cos, np.exp
    f0 = (
        -(E * (cos(x * 2) * cos(y * 3) * exp(z * 4) * 4.0
               - cos(z * 4) * sin(y * 3) * exp(x * 2) * 8.0) * (nu - 0.5)) / den
        + (E * (cos(z * 4) * sin(y * 3) * exp(x * 2) * 4.5
                + sin(x * 2) * sin(z * 4) * exp(y * 3) * 3.0) * (nu - 0.5)) / den
        + (E * nu * cos(x * 2) * cos(y * 3) * exp(z * 4) * 8.0) / den
        - (E * nu * sin(x * 2) * sin(z * 4) * exp(y * 3) * 6.0) / den
        - (E * cos(z * 4) * sin(y * 3) * exp(x * 2) * (nu - 1.0) * 4.0) / den)
    f1 = (
        -(E * (cos(y * 3) * cos(z * 4) * exp(x * 2) * 3.0
               - cos(x * 2) * sin(z * 4) * exp(y * 3) * 2.0) * (nu - 0.5)) / den
        + (E * (cos(x * 2) * sin(z * 4) * exp(y * 3) * 8.0
                + sin(x * 2) * sin(y * 3) * exp(z * 4) * 6.0) * (nu - 0.5)) / den
        + (E * nu * cos(y * 3) * cos(z * 4) * exp(x * 2) * 6.0) / den
        - (E * nu * sin(x * 2) * sin(y * 3) * exp(z * 4) * 12.0) / den
        - (E * cos(x * 2) * sin(z * 4) * exp(y * 3) * (nu - 1.0) * 9.0) / den)
    f2 = (
        -(E * (cos(x * 2) * cos(z * 4) * exp(y * 3) * 6.0
               - cos(y * 3) * sin(x * 2) * exp(z * 4) * 4.5) * (nu - 0.5)) / den
        + (E * (cos(y * 3) * sin(x * 2) * exp(z * 4) * 2.0
                + sin(y * 3) * sin(z * 4) * exp(x * 2) * 4.0) * (nu - 0.5)) / den
        + (E * nu * cos(x * 2) * cos(z * 4) * exp(y * 3) * 12.0) / den
        - (E * nu * sin(y * 3) * sin(z * 4) * exp(x * 2) * 8.0) / den
        - (E * cos(y * 3) * sin(x * 2) * exp(z * 4) * (nu - 1.0) * 16.0) / den)
    return np.stack([f0, f1, f2], axis=1) * MMS_SCALE


def mm(a, b):
    """Pointwise 3x3 products of (n, 3, 3) stacks, as elementwise sums."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(dim=2)


def _inv_sym(C, det):
    """Inverse of symmetric (n, 3, 3) C by its adjugate over det."""
    a = C
    adj = torch.stack([
        a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1],
        a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2],
        a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1],
        a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2],
        a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0],
        a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2],
        a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0],
        a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1],
        a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]], dim=1)
    return adj.reshape(-1, 3, 3) / det[:, None, None]


def _det_minus_one(E2):
    """det(I + E2) - 1 for symmetric E2, expanded without cancellation."""
    e00, e11, e22 = E2[:, 0, 0], E2[:, 1, 1], E2[:, 2, 2]
    e01, e02, e12 = E2[:, 0, 1], E2[:, 0, 2], E2[:, 1, 2]
    return (e00 * (e11 * e22 - e12 * e12) + e01 * (e02 * e12 - e01 * e22)
            + e02 * (e01 * e12 - e02 * e11) + e00 + e11 + e22
            + e00 * e11 + e00 * e22 + e11 * e22
            - e01 * e01 - e02 * e02 - e12 * e12)


def neo_hookean(gradu, lam: float, mu: float):
    """(n, 3, 3) displacement gradients -> the state the residual and its
    linearization read: (F, S, C^-1, lambda log J)."""
    eye = torch.eye(3, dtype=gradu.dtype, device=gradu.device)
    E2 = gradu + gradu.mT + mm(gradu.mT, gradu)
    dm1 = _det_minus_one(E2)
    Cinv = _inv_sym(eye + E2, dm1 + 1.0)
    llnj = lam * torch.log1p(dm1) / 2.0
    S = llnj[:, None, None] * Cinv + mu * mm(Cinv, E2)
    return eye + gradu, S, Cinv, llnj


def first_piola_increment(graddu, state, lam, mu):
    """dP of the exact linearization at `state` (neo_hookean's), applied
    to graddu."""
    F, S, Cinv, llnj = state
    gTF = mm(graddu.mT, F)
    dE = 0.5 * (gTF + gTF.mT)
    cdE = (Cinv * dE).sum(dim=(1, 2))
    dS = (lam * cdE[:, None, None] * Cinv
          - 2.0 * (llnj - mu)[:, None, None] * mm(mm(Cinv, dE), Cinv))
    return mm(graddu, S) + mm(F, dS)


class HyperFSReference:
    """The hyperFS -test operator of a BoxSpace on a device, in
    `precision` (see the module's docstring)."""

    def __init__(self, space: BoxSpace, E: float, nu: float, device,
                 precision: str = "float64", block: int = 2048):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.space = space
        self.device = torch.device(device)
        self.dtype = (torch.float64 if precision == "float64"
                      else torch.float32)
        self.tf32 = precision == "tf32"
        self.block = int(block)
        self.E, self.nu = float(E), float(nu)
        self.lam = E * nu / ((1 + nu) * (1 - 2 * nu))
        self.mu = E / (2 * (1 + nu))
        P = space.P
        Q = P
        gpts, gw = np.polynomial.legendre.leggauss(Q)
        B, D = lagrange(gauss_lobatto(P), gpts)
        G = np.stack([kron3(B, B, D), kron3(B, D, B), kron3(D, B, B)])
        self.G = self._t(G)                                    # (3, Q3, P3)
        self.Bint = self._t(kron3(B, B, B))                    # (Q3, P3)
        w3 = kron3(gw[:, None], gw[:, None], gw[:, None])[:, 0]
        Bl, Dl = lagrange(np.array([-1.0, 1.0]), gpts)
        Gc = np.stack([kron3(Bl, Bl, Dl), kron3(Bl, Dl, Bl),
                       kron3(Dl, Bl, Bl)])                     # (3, Q3, 8)
        xe = space.vertices[space.conn8]                       # (e, 8, 3)
        # dx_i/dX_m at every point (float64 on the host, then cast)
        J = np.einsum("mqa,eai->eqim", Gc, xe)
        detJ = np.linalg.det(J)
        if np.any(detJ <= 0):
            raise ValueError("the mesh has an inverted element")
        self.wdetJ = self._t(w3[None, :] * detJ)               # (e, Q3)
        self.dXdx = self._t(np.linalg.inv(J))                  # (e, Q3, 3, 3)
        self.xq = np.einsum("qa,eai->eqi", kron3(Bl, Bl, Bl), xe)
        self.conn = torch.as_tensor(space.conn, device=self.device)
        m = torch.as_tensor(space.boundary, device=self.device)
        self.mask = m[None, :].expand(3, -1).contiguous()      # (3, N)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                               device=self.device)

    def _mm(self, a, b):
        if self.tf32:
            return tf32_round(a) @ tf32_round(b)
        return a @ b

    def _blocks(self):
        for e0 in range(0, self.space.nelem, self.block):
            yield slice(e0, min(e0 + self.block, self.space.nelem))

    # -- element stages ------------------------------------------------------
    def _grad(self, v, sl):
        """(3, N) -> (e * Q3, 3, 3) physical gradients on block sl."""
        ve = v[:, self.conn[sl]]                              # (3, e, P3)
        ne = ve.shape[1]
        P3, Q3 = self.G.shape[2], self.G.shape[1]
        du = self._mm(ve.reshape(-1, P3), self.G.reshape(-1, P3).T)
        du = du.reshape(3, ne, 3, Q3).permute(1, 3, 0, 2)     # (e, q, c, m)
        return mm(du.reshape(-1, 3, 3), self.dXdx[sl].reshape(-1, 3, 3))

    def _test(self, Pk, sl, out):
        """Add sum_q G^T (P dX/dx^T w detJ) of block sl into out (3, N)."""
        Q3, P3 = self.G.shape[1], self.G.shape[2]
        dv = (mm(Pk, self.dXdx[sl].reshape(-1, 3, 3).mT).reshape(-1, Q3, 3, 3)
              * self.wdetJ[sl][:, :, None, None])             # (e, q, c, m)
        ne = dv.shape[0]
        dv = dv.permute(2, 0, 3, 1).reshape(3 * ne, 3 * Q3)
        ve = self._mm(dv, self.G.reshape(3 * Q3, P3))         # (3 e, P3)
        out.index_add_(1, self.conn[sl].reshape(-1), ve.reshape(3, -1))

    # -- operators -------------------------------------------------------------
    def zeros(self) -> torch.Tensor:
        return torch.zeros((3, self.space.num_nodes), dtype=self.dtype,
                           device=self.device)

    def bc_values(self) -> torch.Tensor:
        """u* at every node (the BC values where the mask is set)."""
        return self._t(mms_solution(self.space.coords).T)

    def forcing(self) -> torch.Tensor:
        """(3, N) F = sum over elements of B^T f(x_q) w detJ."""
        F = self.zeros()
        f = mms_force(self.xq.reshape(-1, 3), self.E, self.nu)
        fq = self._t(f.reshape(self.space.nelem, -1, 3))      # (e, Q3, 3)
        for sl in self._blocks():
            w = fq[sl] * self.wdetJ[sl][:, :, None]
            fe = self._mm(w.permute(2, 0, 1).reshape(-1, w.shape[1]),
                          self.Bint)                          # (3 e, P3)
            F.index_add_(1, self.conn[sl].reshape(-1), fe.reshape(3, -1))
        return F

    def residual(self, u):
        """Unmasked internal force R(u) (3, N) and the stash: a block's
        neo_hookean state at its points, a list over blocks."""
        r, stash = self.zeros(), []
        for sl in self._blocks():
            state = neo_hookean(self._grad(u, sl), self.lam, self.mu)
            stash.append(state)
            F, S = state[0], state[1]
            self._test(mm(F, S), sl, r)
        return r, stash

    def jacobian(self, v, stash):
        """Masked J v (3, N): the linearization at the stash, with the
        constrained DOFs' input and output zeroed."""
        v = torch.where(self.mask, 0.0, v)
        out = self.zeros()
        for sl, state in zip(self._blocks(), stash):
            dP = first_piola_increment(self._grad(v, sl), state, self.lam,
                                       self.mu)
            self._test(dP, sl, out)
        return torch.where(self.mask, 0.0, out)

    def diagonal(self, stash):
        """(3, N) diagonal of the masked J (1 at constrained DOFs): the
        pointwise tangent from 9 unit gradients, contracted with the
        basis gradients at each point."""
        G = self.G                                            # (3, Q3, P3)
        out = self.zeros()
        for sl, state in zip(self._blocks(), stash):
            ne = sl.stop - sl.start
            Q3, P3 = G.shape[1], G.shape[2]
            dXdx = self.dXdx[sl].reshape(-1, 3, 3)
            w = self.wdetJ[sl].reshape(-1)
            de = torch.zeros((3, ne, P3), dtype=self.dtype,
                             device=self.device)
            for c in range(3):
                for m2 in range(3):
                    du = torch.zeros((ne * Q3, 3, 3), dtype=self.dtype,
                                     device=self.device)
                    du[:, c, m2] = 1.0
                    dP = first_piola_increment(mm(du, dXdx), state,
                                               self.lam, self.mu)
                    # K[c, m1, c, m2] at every point, m1 free
                    K = (mm(dP, dXdx.mT) * w[:, None, None])[:, c, :]
                    K = K.reshape(ne, Q3, 3).permute(0, 2, 1)
                    de[c] += self._mm(K.reshape(ne, 3 * Q3),
                                      (G * G[m2]).reshape(3 * Q3, P3))
            out.index_add_(1, self.conn[sl].reshape(-1), de.reshape(3, -1))
        return torch.where(self.mask, 1.0, out)
