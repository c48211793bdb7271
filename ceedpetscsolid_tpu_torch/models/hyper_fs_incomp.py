"""Nearly incompressible finite-strain Neo-Hookean, the reference's split
(qfunctions/hyperFSIncomp.h). Port of
ceedpetscsolid_tpu/models/hyper_fs_incomp.py.

The second Piola-Kirchhoff stress splits into
  * a deviatoric mu part S_mu = mu C^{-1} (2E), integrated at full
    quadrature (hyperFSIncomp.h:144-283);
  * a pressure part S_p = (lambda log J) C^{-1}, integrated at one
    quadrature point per element with its own Q = 1 qdata
    (hyperFSIncomp.h:286-408, src/setuplibceed.c:404-506);
summed by a composite operator. Jacobians: dS_mu = 2 mu C^{-1} dE C^{-1};
dS_p = lambda (C^{-1}:dE) C^{-1} - 2 (lambda log J) C^{-1} dE C^{-1}. Each
part's residual stashes its own gradu. Energy and diagnostics are
hyperFS's (hyperFSIncomp.h:767-859, src/setuplibceed.c:93).
"""

from __future__ import annotations

from .base import (
    Mat3,
    Physics,
    log1p_series_shifted,
    mat_ddot,
    mat_eye_plus,
    mat_mul,
    mat_T1_mul,
    ref_to_phys_grad,
    unpack_qdata,
    weight_test_grad,
)
from .hyper_fs import _det_cm1, _green_lagrange_2E, _sym_inv
from .hyper_fs import energy_qf as _fs_energy_qf

name = "hyperFSIncomp"
nonlinear = True
composite = True            # plus the reduced-integration pressure operator
pressure_name = "hyperFSIncomp-pressure"


def _common(gradu: Mat3):
    """E2 = 2E, detC - 1, Cinv (commonFS_incomp, hyperFSIncomp.h:69-137)."""
    E2 = _green_lagrange_2E(gradu)
    detC_m1 = _det_cm1(E2)
    Cinv = _sym_inv(mat_eye_plus(E2), detC_m1 + 1.0)
    return E2, detC_m1, Cinv


def _dE(graddu: Mat3, F: Mat3) -> Mat3:
    gTF = mat_T1_mul(graddu, F)
    return 0.5 * (gTF + gTF.T)


# -- deviatoric mu part (full quadrature) ------------------------------------
def residual_planes(du_ref: Mat3, qdata, phys: Physics):
    wdetJ, dXdx = unpack_qdata(qdata)
    gradu = ref_to_phys_grad(du_ref, dXdx)
    E2, _, Cinv = _common(gradu)
    S = phys.mu * mat_mul(Cinv, E2)
    P = mat_mul(mat_eye_plus(gradu), S)
    return weight_test_grad(P, dXdx, wdetJ), gradu


def jacobian_planes(ddu_ref: Mat3, qdata, gradu: Mat3, phys: Physics) -> Mat3:
    wdetJ, dXdx = unpack_qdata(qdata)
    graddu = ref_to_phys_grad(ddu_ref, dXdx)
    E2, _, Cinv = _common(gradu)
    S = phys.mu * mat_mul(Cinv, E2)
    F = mat_eye_plus(gradu)
    dS = 2.0 * phys.mu * mat_mul(Cinv, mat_mul(_dE(graddu, F), Cinv))
    dP = mat_mul(graddu, S) + mat_mul(F, dS)
    return weight_test_grad(dP, dXdx, wdetJ)


# -- pressure part (reduced integration, Q = 1) -------------------------------
def pressure_residual_planes(du_ref: Mat3, qdata, phys: Physics):
    wdetJ, dXdx = unpack_qdata(qdata)
    gradu = ref_to_phys_grad(du_ref, dXdx)
    _, detC_m1, Cinv = _common(gradu)
    llnj = phys.lam * log1p_series_shifted(detC_m1) / 2.0
    P = mat_mul(mat_eye_plus(gradu), llnj * Cinv)
    return weight_test_grad(P, dXdx, wdetJ), gradu


def pressure_jacobian_planes(ddu_ref: Mat3, qdata, gradu: Mat3,
                             phys: Physics) -> Mat3:
    wdetJ, dXdx = unpack_qdata(qdata)
    graddu = ref_to_phys_grad(ddu_ref, dXdx)
    _, detC_m1, Cinv = _common(gradu)
    llnj = phys.lam * log1p_series_shifted(detC_m1) / 2.0
    S = llnj * Cinv
    F = mat_eye_plus(gradu)
    dE = _dE(graddu, F)
    CidECi = mat_mul(Cinv, mat_mul(dE, Cinv))
    dS = phys.lam * mat_ddot(Cinv, dE) * Cinv - 2.0 * llnj * CidECi
    dP = mat_mul(graddu, S) + mat_mul(F, dS)
    return weight_test_grad(dP, dXdx, wdetJ)


# -- (3, 3, *batch)-tensor adapters ------------------------------------------
def residual_qf(du_ref, qdata, phys: Physics):
    dv, stash = residual_planes(Mat3.from_array(du_ref), qdata, phys)
    return dv.to_array(), stash


def jacobian_qf(ddu_ref, qdata, stash: Mat3, phys: Physics):
    return jacobian_planes(Mat3.from_array(ddu_ref), qdata, stash,
                           phys).to_array()


def pressure_residual_qf(du_ref, qdata, phys: Physics):
    dv, stash = pressure_residual_planes(Mat3.from_array(du_ref), qdata, phys)
    return dv.to_array(), stash


def pressure_jacobian_qf(ddu_ref, qdata, stash: Mat3, phys: Physics):
    return pressure_jacobian_planes(Mat3.from_array(ddu_ref), qdata, stash,
                                    phys).to_array()


energy_qf = _fs_energy_qf           # hyperFSIncomp.h:767-859 == hyperFS form
