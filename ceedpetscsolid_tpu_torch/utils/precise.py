"""Float64-accumulated reductions for the float32 GPU path.

The CG/Newton reduction scalars need f64-grade accuracy to honour the
reference's tolerance contract (CG natural-norm rtol 1e-10,
elasticity.c:504-507). The JAX package builds them out of f32 ops with
compensated (double-float) arithmetic because the TPU has no f64 vector
unit; a GPU does, so here the products are formed and summed in float64.
The result is a 0-dim float64 tensor on the input's device: reading it on
the host is the caller's choice (and its sync).

`accurate_matmuls` has no counterpart: float32 contractions on the GPU run
in IEEE f32 once TF32 is off (problem.select_device).
"""

from __future__ import annotations

import torch


def dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) accumulated in float64 (0-dim float64 tensor)."""
    return torch.dot(a.reshape(-1).to(torch.float64),
                     b.reshape(-1).to(torch.float64))


def norm2(a: torch.Tensor) -> torch.Tensor:
    """2-norm accumulated in float64."""
    return torch.sqrt(torch.abs(dot2(a, a)))
