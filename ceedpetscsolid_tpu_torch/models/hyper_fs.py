"""Neo-Hookean hyperelasticity at finite strain, total Lagrangian
(reference qfunctions/hyperFS.h). Port of ceedpetscsolid_tpu/models/hyper_fs.py.

Stable formulation: E2 = gradu + gradu^T + gradu^T gradu, C = I + E2,
S = (lambda log J) C^{-1} + mu C^{-1} E2 (hyperFS.h:85-142 via commonFS),
P = F S, with det(C) - 1 in the cancellation-free expanded form
(hyperFS.h:72-80) and log J through the shifted log1p series
(hyperFS.h:45-67). Analytic Newton linearization:
dS = lambda (C^{-1}:dE) C^{-1} - 2(lambda log J - mu) C^{-1} dE C^{-1},
dP = graddu S + F dS (hyperFS.h:414-451).

These plain-torch planes functions are the reference the CUDA kernel in
csrc/fused_apply.cu is transcribed from and tested against.
"""

from __future__ import annotations

import torch

from .base import (
    Mat3,
    Physics,
    log1p_series_shifted,
    mat_ddot,
    mat_eye_plus,
    mat_mul,
    mat_T1_mul,
    mat_trace,
    ref_to_phys_grad,
    unpack_qdata,
    weight_test_grad,
)

name = "hyperFS"
nonlinear = True


def _det_cm1(E2: Mat3) -> torch.Tensor:
    """det(I + E2) - 1 in expanded cancellation-free form (hyperFS.h:72-80)."""
    e00, e11, e22 = E2[0, 0], E2[1, 1], E2[2, 2]
    e12, e02, e01 = E2[1, 2], E2[0, 2], E2[0, 1]
    return (
        e00 * (e11 * e22 - e12 * e12)
        + e01 * (e02 * e12 - e01 * e22)
        + e02 * (e01 * e12 - e02 * e11)
        + e00 + e11 + e22
        + e00 * e11 + e00 * e22 + e11 * e22
        - e01 * e01 - e02 * e02 - e12 * e12
    )


def _sym_inv(C: Mat3, det) -> Mat3:
    """Inverse of symmetric 3x3 planes via adjugate / det (hyperFS.h:115-124)."""
    a00 = C[1, 1] * C[2, 2] - C[1, 2] * C[2, 1]
    a11 = C[0, 0] * C[2, 2] - C[0, 2] * C[2, 0]
    a22 = C[0, 0] * C[1, 1] - C[0, 1] * C[1, 0]
    a12 = C[0, 2] * C[1, 0] - C[0, 0] * C[1, 2]
    a02 = C[0, 1] * C[1, 2] - C[0, 2] * C[1, 1]
    a01 = C[0, 2] * C[2, 1] - C[0, 1] * C[2, 2]
    inv = 1.0 / det
    return Mat3([a00 * inv, a01 * inv, a02 * inv,
                 a01 * inv, a11 * inv, a12 * inv,
                 a02 * inv, a12 * inv, a22 * inv])


def _green_lagrange_2E(gradu: Mat3) -> Mat3:
    """E2 = gradu + gradu^T + gradu^T gradu (hyperFS.h:89-97)."""
    return gradu + gradu.T + mat_T1_mul(gradu, gradu)


def common_fs(gradu: Mat3, phys: Physics):
    """commonFS (hyperFS.h:85-142): returns (S, Cinv, detC_m1, llnj, E2)."""
    E2 = _green_lagrange_2E(gradu)
    detC_m1 = _det_cm1(E2)
    C = mat_eye_plus(E2)
    Cinv = _sym_inv(C, detC_m1 + 1.0)
    llnj = phys.lam * log1p_series_shifted(detC_m1) / 2.0
    S = llnj * Cinv + phys.mu * mat_mul(Cinv, E2)
    return S, Cinv, detC_m1, llnj, E2


def residual_planes(du_ref: Mat3, qdata, phys: Physics):
    """(du_ref, qdata) -> (dv_ref, stash = gradu)."""
    wdetJ, dXdx = unpack_qdata(qdata)
    gradu = ref_to_phys_grad(du_ref, dXdx)
    S, _, _, _, _ = common_fs(gradu, phys)
    F = mat_eye_plus(gradu)
    P = mat_mul(F, S)
    return weight_test_grad(P, dXdx, wdetJ), gradu


def jacobian_planes(ddu_ref: Mat3, qdata, gradu: Mat3, phys: Physics) -> Mat3:
    """(ddu_ref, qdata, stashed gradu) -> linearized dv_ref."""
    wdetJ, dXdx = unpack_qdata(qdata)
    graddu = ref_to_phys_grad(ddu_ref, dXdx)
    S, Cinv, _, llnj, _ = common_fs(gradu, phys)
    F = mat_eye_plus(gradu)
    # dE = 1/2 (graddu^T F + F^T graddu)  (hyperFS.h:382-389)
    gTF = mat_T1_mul(graddu, F)
    dE = 0.5 * (gTF + gTF.T)
    cinv_dE = mat_ddot(Cinv, dE)
    CidECi = mat_mul(Cinv, mat_mul(dE, Cinv))
    dS = phys.lam * cinv_dE * Cinv - 2.0 * (llnj - phys.mu) * CidECi
    dP = mat_mul(graddu, S) + mat_mul(F, dS)
    return weight_test_grad(dP, dXdx, wdetJ)


# -- (3, 3, *batch)-tensor adapters ------------------------------------------
def residual_qf(du_ref, qdata, phys: Physics):
    dv, stash = residual_planes(Mat3.from_array(du_ref), qdata, phys)
    return dv.to_array(), stash


def jacobian_qf(ddu_ref, qdata, stash: Mat3, phys: Physics):
    return jacobian_planes(Mat3.from_array(ddu_ref), qdata, stash,
                           phys).to_array()


def energy_qf(du_ref, qdata, phys: Physics):
    """Pointwise strain energy density x wdetJ (hyperFS.h:546-549)."""
    wdetJ, dXdx = unpack_qdata(qdata)
    gradu = ref_to_phys_grad(Mat3.from_array(du_ref), dXdx)
    E2 = _green_lagrange_2E(gradu)
    detC_m1 = _det_cm1(E2)
    logj = log1p_series_shifted(detC_m1) / 2.0
    trE2 = mat_trace(E2)
    return (phys.lam * logj * logj / 2 - phys.mu * logj
            + phys.mu * trE2 / 2) * wdetJ


def diagnostic_qf(u, du_ref, qdata, phys: Physics):
    """(8, *batch) planes: ux, uy, uz, pressure -lambda log J, tr(E),
    E:E, J = sqrt(det C) and the strain energy density (hyperFS.h:559-661),
    with E = E2 / 2. u: (3, *batch)."""
    _, dXdx = unpack_qdata(qdata)
    gradu = ref_to_phys_grad(Mat3.from_array(du_ref), dXdx)
    E2 = _green_lagrange_2E(gradu)
    detC_m1 = _det_cm1(E2)
    logj = log1p_series_shifted(detC_m1) / 2.0
    trE2 = mat_trace(E2)
    energy = phys.lam * logj * logj / 2 - phys.mu * logj + phys.mu * trE2 / 2
    return torch.stack([u[0], u[1], u[2], -phys.lam * logj, trE2 / 2,
                        mat_ddot(E2, E2) / 4, torch.sqrt(detC_m1 + 1),
                        energy])
