"""Method-of-manufactured-solutions data (reference qfunctions/manufacturedTrue.h,
manufacturedForce.h, src/boundary.c BCMMS). Port of
ceedpetscsolid_tpu/models/mms.py.

True solution (manufacturedTrue.h:41-54, boundary.c:40-42):
    u = ( e^{2x} sin 3y cos 4z,  e^{3y} sin 4z cos 2x,  e^{4z} sin 2x cos 3y ) / 1e8

The forcing is the analytic -div(sigma(u*)) for the reference's linear
elasticity constitutive law, transcribed from manufacturedForce.h:55-101
(already includes the 1e8 scaling; multiplied by w*detJ at quadrature).
"""

from __future__ import annotations

import torch


def true_solution(xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) coords -> (..., 3) displacement."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack(
        [
            torch.exp(2 * x) * torch.sin(3 * y) * torch.cos(4 * z),
            torch.exp(3 * y) * torch.sin(4 * z) * torch.cos(2 * x),
            torch.exp(4 * z) * torch.sin(2 * x) * torch.cos(3 * y),
        ],
        dim=-1,
    ) / 1e8


def mms_force(xyz_cm: torch.Tensor, wdetJ: torch.Tensor, phys) -> torch.Tensor:
    """(3, *batch) coordinate planes, (*batch,) wdetJ -> (3, *batch) weighted
    force planes. Verbatim transcription of manufacturedForce.h:62-101."""
    x, y, z = xyz_cm[0], xyz_cm[1], xyz_cm[2]
    E, nu = phys.E, phys.nu
    den = (nu * 2.0 - 1.0) * (nu + 1.0)
    sin, cos, exp = torch.sin, torch.cos, torch.exp

    f0 = (
        -(E * (cos(x * 2) * cos(y * 3) * exp(z * 4) * 4.0
               - cos(z * 4) * sin(y * 3) * exp(x * 2) * 8.0) * (nu - 0.5)) / den
        + (E * (cos(z * 4) * sin(y * 3) * exp(x * 2) * 4.5
                + sin(x * 2) * sin(z * 4) * exp(y * 3) * 3.0) * (nu - 0.5)) / den
        + (E * nu * cos(x * 2) * cos(y * 3) * exp(z * 4) * 8.0) / den
        - (E * nu * sin(x * 2) * sin(z * 4) * exp(y * 3) * 6.0) / den
        - (E * cos(z * 4) * sin(y * 3) * exp(x * 2) * (nu - 1.0) * 4.0) / den
    )
    f1 = (
        -(E * (cos(y * 3) * cos(z * 4) * exp(x * 2) * 3.0
               - cos(x * 2) * sin(z * 4) * exp(y * 3) * 2.0) * (nu - 0.5)) / den
        + (E * (cos(x * 2) * sin(z * 4) * exp(y * 3) * 8.0
                + sin(x * 2) * sin(y * 3) * exp(z * 4) * 6.0) * (nu - 0.5)) / den
        + (E * nu * cos(y * 3) * cos(z * 4) * exp(x * 2) * 6.0) / den
        - (E * nu * sin(x * 2) * sin(y * 3) * exp(z * 4) * 12.0) / den
        - (E * cos(x * 2) * sin(z * 4) * exp(y * 3) * (nu - 1.0) * 9.0) / den
    )
    f2 = (
        -(E * (cos(x * 2) * cos(z * 4) * exp(y * 3) * 6.0
               - cos(y * 3) * sin(x * 2) * exp(z * 4) * 4.5) * (nu - 0.5)) / den
        + (E * (cos(y * 3) * sin(x * 2) * exp(z * 4) * 2.0
                + sin(y * 3) * sin(z * 4) * exp(x * 2) * 4.0) * (nu - 0.5)) / den
        + (E * nu * cos(x * 2) * cos(z * 4) * exp(y * 3) * 12.0) / den
        - (E * nu * sin(y * 3) * sin(z * 4) * exp(x * 2) * 8.0) / den
        - (E * cos(y * 3) * sin(x * 2) * exp(z * 4) * (nu - 1.0) * 16.0) / den
    )
    return torch.stack([f0, f1, f2], dim=0) * wdetJ / 1e8
