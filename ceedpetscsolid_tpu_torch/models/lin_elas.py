"""Linear elasticity (reference qfunctions/linElas.h).
Port of ceedpetscsolid_tpu/models/lin_elas.py.

sigma = lambda tr(eps) I + 2 mu eps with eps = sym(grad u) in the
reference's Voigt form (linElas.h:133-144), which applies mu, not 2 mu, to
the tensor shear strain; kept verbatim because the MMS forcing
(manufacturedForce.h) is consistent with it. The Jacobian is the same
operator (linElas.h:163-280); the residual stashes nothing. Energy follows
linElas.h:363-366 verbatim, and the nodal diagnostics linElas.h:376-479.
"""

from __future__ import annotations

import torch

from .base import (
    Mat3,
    Physics,
    mat_ddot,
    mat_scale_eye_plus,
    mat_trace,
    ref_to_phys_grad,
    sym,
    unpack_qdata,
    weight_test_grad,
)

name = "linElas"
nonlinear = False


def voigt_params(phys: Physics) -> tuple[float, float]:
    """(lambda, shear factor) of the reference's Voigt form: ss nu and
    ss (1 - 2 nu) / 2 with ss = E / ((1 + nu)(1 - 2 nu))."""
    ss = phys.E / ((1 + phys.nu) * (1 - 2 * phys.nu))
    return ss * phys.nu, ss * (1 - 2 * phys.nu) / 2


def _sigma(e: Mat3, phys: Physics) -> Mat3:
    # closed form of the Voigt product: lam tr(e) I + mu (e + diag(e))
    lam_voigt, mu = voigt_params(phys)
    tr = mat_trace(e)
    s = [mu * p for p in e.m]
    for d in range(3):
        s[4 * d] = s[4 * d] + mu * e.m[4 * d]
    return mat_scale_eye_plus(lam_voigt * tr, Mat3(s))


def residual_planes(du_ref: Mat3, qdata, phys: Physics):
    """(du_ref, qdata) -> (dv_ref, None): a linear model stashes nothing."""
    wdetJ, dXdx = unpack_qdata(qdata)
    gradu = ref_to_phys_grad(du_ref, dXdx)
    return weight_test_grad(_sigma(sym(gradu), phys), dXdx, wdetJ), None


def jacobian_planes(ddu_ref: Mat3, qdata, stash, phys: Physics) -> Mat3:
    """The residual operator itself (linElas.h:163); stash is unused."""
    wdetJ, dXdx = unpack_qdata(qdata)
    graddu = ref_to_phys_grad(ddu_ref, dXdx)
    return weight_test_grad(_sigma(sym(graddu), phys), dXdx, wdetJ)


# -- (3, 3, *batch)-tensor adapters ------------------------------------------
def residual_qf(du_ref, qdata, phys: Physics):
    dv, stash = residual_planes(Mat3.from_array(du_ref), qdata, phys)
    return dv.to_array(), stash


def jacobian_qf(ddu_ref, qdata, stash, phys: Physics):
    return jacobian_planes(Mat3.from_array(ddu_ref), qdata, stash,
                           phys).to_array()


def energy_qf(du_ref, qdata, phys: Physics):
    wdetJ, dXdx = unpack_qdata(qdata)
    e = sym(ref_to_phys_grad(Mat3.from_array(du_ref), dXdx))
    tr = mat_trace(e)
    shear = e[0, 1] ** 2 + e[0, 2] ** 2 + e[1, 2] ** 2
    # verbatim reference expression (linElas.h:363-366)
    return (phys.lam * tr * tr / 2 + tr * phys.mu
            + shear * 2 * phys.mu) * wdetJ


def diagnostic_qf(u, du_ref, qdata, phys: Physics):
    """(8, *batch) planes: ux, uy, uz, pressure, tr(e), e:e, 1 + tr(e) and
    the strain energy density (linElas.h:376-479). u: (3, *batch)."""
    _, dXdx = unpack_qdata(qdata)
    e = sym(ref_to_phys_grad(Mat3.from_array(du_ref), dXdx))
    tr = mat_trace(e)
    shear = e[0, 1] ** 2 + e[0, 2] ** 2 + e[1, 2] ** 2
    energy = phys.lam * tr * tr / 2 + tr * phys.mu + shear * 2 * phys.mu
    return torch.stack([u[0], u[1], u[2], -phys.lam * tr, tr, mat_ddot(e, e),
                        1 + tr, energy])
