"""Neo-Hookean hyperelasticity at small strain (reference
qfunctions/hyperSS.h). Port of ceedpetscsolid_tpu/models/hyper_ss.py.

sigma = lambda log(1 + e_v) I + 2 mu eps with e_v = tr(eps), log through the
unshifted log1p series (hyperSS.h:43-55). The Newton linearization replaces
lambda by lambda_bar = lambda / (1 + e_v) of the stashed state
(hyperSS.h:293-302). The residual stashes the physical gradient gradu
(hyperSS.h:69-70, 115-120). Energy and nodal diagnostics follow
hyperSS.h:405-408 and 418-522.
"""

from __future__ import annotations

import torch

from .base import (
    Mat3,
    Physics,
    log1p_series,
    mat_ddot,
    mat_scale_eye_plus,
    mat_trace,
    ref_to_phys_grad,
    sym,
    unpack_qdata,
    weight_test_grad,
)

name = "hyperSS"
nonlinear = True


def residual_planes(du_ref: Mat3, qdata, phys: Physics):
    """(du_ref, qdata) -> (dv_ref, stash = gradu)."""
    wdetJ, dXdx = unpack_qdata(qdata)
    gradu = ref_to_phys_grad(du_ref, dXdx)
    e = sym(gradu)
    llv = log1p_series(mat_trace(e))
    # hyperSS.h:156-163: diag lambda llv + 2 mu e_ii, off-diag 2 mu e_ij
    sigma = mat_scale_eye_plus(phys.lam * llv, phys.two_mu * e)
    return weight_test_grad(sigma, dXdx, wdetJ), gradu


def jacobian_planes(ddu_ref: Mat3, qdata, gradu: Mat3, phys: Physics) -> Mat3:
    wdetJ, dXdx = unpack_qdata(qdata)
    de = sym(ref_to_phys_grad(ddu_ref, dXdx))
    # lambda_bar from the stashed state gradient (hyperSS.h:294-295)
    ev = gradu[0, 0] + gradu[1, 1] + gradu[2, 2]
    lam_bar = phys.lam / (1 + ev)
    dsigma = mat_scale_eye_plus(lam_bar * mat_trace(de), phys.two_mu * de)
    return weight_test_grad(dsigma, dXdx, wdetJ)


# -- (3, 3, *batch)-tensor adapters ------------------------------------------
def residual_qf(du_ref, qdata, phys: Physics):
    dv, stash = residual_planes(Mat3.from_array(du_ref), qdata, phys)
    return dv.to_array(), stash


def jacobian_qf(ddu_ref, qdata, stash: Mat3, phys: Physics):
    return jacobian_planes(Mat3.from_array(ddu_ref), qdata, stash,
                           phys).to_array()


def energy_qf(du_ref, qdata, phys: Physics):
    wdetJ, dXdx = unpack_qdata(qdata)
    e = sym(ref_to_phys_grad(Mat3.from_array(du_ref), dXdx))
    ev = mat_trace(e)
    llv = log1p_series(ev)
    shear = e[0, 1] ** 2 + e[0, 2] ** 2 + e[1, 2] ** 2
    # verbatim hyperSS.h:405-408
    return (phys.lam * (1 + ev) * (llv - 1) + ev * phys.mu
            + shear * 2 * phys.mu) * wdetJ


def diagnostic_qf(u, du_ref, qdata, phys: Physics):
    """(8, *batch) planes as lin_elas.diagnostic_qf's, with the pressure
    -lambda log(1 + tr e) (hyperSS.h:418-522). u: (3, *batch)."""
    _, dXdx = unpack_qdata(qdata)
    e = sym(ref_to_phys_grad(Mat3.from_array(du_ref), dXdx))
    ev = mat_trace(e)
    llv = log1p_series(ev)
    shear = e[0, 1] ** 2 + e[0, 2] ** 2 + e[1, 2] ** 2
    energy = (phys.lam * (1 + ev) * (llv - 1) + ev * phys.mu
              + shear * 2 * phys.mu)
    return torch.stack([u[0], u[1], u[2], -phys.lam * llv, ev, mat_ddot(e, e),
                        1 + ev, energy])
