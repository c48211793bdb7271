"""Fused element apply: gather -> B -> pointwise physics -> B^T, per element.

Counterpart of ceedpetscsolid_tpu/ops/pallas_apply.py (the TPU kernel
`_apply_kernel` built by `make_fused_apply` for every model's
`residual_planes` / `jacobian_planes`). Two implementations of one
function:

  * `residual_plain` / `jacobian_plain`: plain torch (conn gather, Kronecker
    einsum, Mat3 physics, adjoint einsum). The CPU path and the reference
    the kernel is tested against.
  * the CUDA kernel in csrc/fused_apply.cu, launched by `residual` /
    `jacobian` for tensors on a CUDA device.

The pointwise physics is one of `PHYSICS` (by name): hyperFS, linElas,
hyperSS, and hyperFSIncomp's two parts, the deviatoric mu part at full
quadrature and the pressure part at one point per element. The CUDA kernel
takes it as a template parameter (ids shared with csrc/fused_apply.cu).

`residual` and `jacobian` choose by the device of their input: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel, and raises if
the kernel cannot be built or has no instance for its (physics, P, Q,
dtype). There is no fallback from CUDA to the plain version.

Outputs are E-vectors (3, nelem, P3); the owner-sum to the L-vector is
ops/restriction.Restriction.scatter_add. The stash is one contiguous
(9, nelem, Q3) tensor: plane 3c+k holds gradu[c, k]. A physics without a
stash (linElas) returns None for it and takes None.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable

import torch

from ..models import hyper_fs, hyper_fs_incomp, hyper_ss, lin_elas
from ..models.base import Mat3, Physics
from .basis import Basis3D

# (P, Q) instances compiled into the kernel library for the full-quadrature
# physics: every 2 <= P <= Q <= 6, i.e. degrees 1-5 at their own Gauss rule
# and every coarser p-multigrid level at a finer level's rule; the pressure
# term has (P, 1) for 2 <= P <= 6. The one place the limit is set:
# csrc/build.py passes it to nvcc as -DCPS_FUSED_MAX_Q.
MAX_Q = 6
INSTANTIATED_PQ = frozenset((P, Q) for Q in range(2, MAX_Q + 1)
                            for P in range(2, Q + 1))
REDUCED_PQ = frozenset((P, 1) for P in range(2, MAX_Q + 1))
_DTYPES = {torch.float32: 0, torch.float64: 1}


@dataclass(frozen=True)
class Pointwise:
    """One pointwise physics of the fused apply.

    kernel_id: the template argument of csrc/fused_apply.cu; params: the
    kernel's two scalars (a, b) from the material; stash: whether the
    residual writes (and the Jacobian reads) the gradu stash; instances:
    the (P, Q) pairs compiled for it."""

    name: str
    kernel_id: int
    residual_planes: Callable
    jacobian_planes: Callable
    params: Callable[[Physics], tuple[float, float]]
    stash: bool = True
    instances: frozenset = INSTANTIATED_PQ


def _lam_mu(phys: Physics) -> tuple[float, float]:
    return phys.lam, phys.mu


PHYSICS = {pw.name: pw for pw in (
    Pointwise("hyperFS", 0, hyper_fs.residual_planes,
              hyper_fs.jacobian_planes, _lam_mu),
    Pointwise("linElas", 1, lin_elas.residual_planes,
              lin_elas.jacobian_planes, lin_elas.voigt_params, stash=False),
    Pointwise("hyperSS", 2, hyper_ss.residual_planes,
              hyper_ss.jacobian_planes, lambda p: (p.lam, p.two_mu)),
    Pointwise("hyperFSIncomp", 3, hyper_fs_incomp.residual_planes,
              hyper_fs_incomp.jacobian_planes, _lam_mu),
    Pointwise(hyper_fs_incomp.pressure_name, 4,
              hyper_fs_incomp.pressure_residual_planes,
              hyper_fs_incomp.pressure_jacobian_planes, _lam_mu,
              instances=REDUCED_PQ),
)}


def pointwise(physics: str | Pointwise) -> Pointwise:
    """The Pointwise of a physics name (a Pointwise passes through)."""
    if isinstance(physics, Pointwise):
        return physics
    try:
        return PHYSICS[physics]
    except KeyError:
        raise ValueError(f"fused apply has no physics {physics!r}; choose "
                         f"from {sorted(PHYSICS)}") from None


class LaunchCounts:
    """Kernel launches per mode, per (mode, P, Q) and per (physics, mode,
    P, Q), counted where the wrapper launches. Launch bookkeeping only:
    nothing reads it to decide anything."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.residual_launches = 0
        self.jacobian_launches = 0
        self.by_pq = {}             # ("residual" | "jacobian", P, Q) -> n
        self.by_physics = {}        # (physics, mode, P, Q) -> n

    def add(self, mode: str, basis: Basis3D, physics: str = "hyperFS"):
        if mode == "residual":
            self.residual_launches += 1
        else:
            self.jacobian_launches += 1
        key = (mode, basis.P, basis.Q)
        self.by_pq[key] = self.by_pq.get(key, 0) + 1
        key = (physics, *key)
        self.by_physics[key] = self.by_physics.get(key, 0) + 1


COUNTS = LaunchCounts()


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------
def residual_plain(u, conn, qdata, basis: Basis3D, phys: Physics,
                   physics: str | Pointwise = "hyperFS"):
    """(u (3, N), conn (nelem, P3), qdata (10, nelem, Q3)) ->
    (ve (3, nelem, P3), stash (9, nelem, Q3) or None)."""
    pw = pointwise(physics)
    du = basis.apply_grad(u[:, conn])                     # (3, 3, e, Q3)
    dv, gradu = pw.residual_planes(Mat3.from_array(du), qdata, phys)
    stash = None if gradu is None else torch.stack(gradu.m)
    return basis.apply_grad_T(dv.to_array()), stash


def jacobian_plain(v, conn, qdata, stash, basis: Basis3D, phys: Physics,
                   physics: str | Pointwise = "hyperFS"):
    """(v (3, N), ..., stash (9, nelem, Q3) or None) -> J.v E-vector
    (3, nelem, P3)."""
    pw = pointwise(physics)
    ddu = basis.apply_grad(v[:, conn])
    st = None if stash is None else Mat3(stash.unbind(0))
    dv = pw.jacobian_planes(Mat3.from_array(ddu), qdata, st, phys)
    return basis.apply_grad_T(dv.to_array())


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library():
    """Build (first use) and load the kernel library."""
    from ..csrc.build import build

    path, _ = build()
    lib = ctypes.CDLL(str(path))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.cps_fused_apply.argtypes = [
        c_int, c_int, c_int, c_int, c_int,     # physics, jacobian, P, Q, f64
        c_ptr, ctypes.c_longlong, c_ptr, c_int,   # u, N, conn, nelem
        c_ptr, c_ptr, c_ptr,                   # qdata, B, D
        c_ptr, c_ptr,                          # stash, ve
        ctypes.c_double, ctypes.c_double,      # the physics' (a, b)
        c_ptr,                                 # stream
    ]
    lib.cps_fused_apply.restype = c_int
    return lib


def _check(u, conn, qdata, basis: Basis3D, stash,
           physics: str | Pointwise = "hyperFS"):
    """Validate what the kernel takes; raise on anything else. `stash` is
    None for a physics without one."""
    pw = pointwise(physics)
    dev, dt = u.device, u.dtype
    P, Q = basis.P, basis.Q
    if (P, Q) not in pw.instances:
        raise NotImplementedError(
            f"fused CUDA apply has no instance for P={P}, Q={Q} of "
            f"{pw.name} (instances: {sorted(pw.instances)})")
    if dt not in _DTYPES:
        raise TypeError(f"fused CUDA apply takes float32/float64, got {dt}")
    nelem = conn.shape[0]
    expect = {
        "u": (u, (3, u.shape[1]), dt),
        "conn": (conn, (nelem, P ** 3), torch.int64),
        "qdata": (qdata, (10, nelem, Q ** 3), dt),
        "basis.B": (basis.B, (Q, P), dt),
        "basis.D": (basis.D, (Q, P), dt),
    }
    if pw.stash:
        expect["stash"] = (stash, (9, nelem, Q ** 3), dt)
    elif stash is not None:
        raise ValueError(f"{pw.name} has no stash; got one")
    for name, (t, shape, tdt) in expect.items():
        if t is None:
            raise ValueError(f"{name} is missing")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != tdt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {tdt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nelem >= 2 ** 31:
        raise ValueError(f"nelem={nelem} exceeds the kernel's grid limit")


def _launch(jacobian: bool, u, conn, qdata, basis, stash, ve, phys,
            pw: Pointwise):
    lib = _library()
    a, b = pw.params(phys)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.cps_fused_apply(
            pw.kernel_id, int(jacobian), basis.P, basis.Q, _DTYPES[u.dtype],
            u.data_ptr(), u.shape[1], conn.data_ptr(), conn.shape[0],
            qdata.data_ptr(), basis.B.data_ptr(), basis.D.data_ptr(),
            None if stash is None else stash.data_ptr(), ve.data_ptr(),
            float(a), float(b), stream)
    if err != 0:
        raise RuntimeError(f"fused_apply kernel launch failed: cuda error {err}"
                           if err > 0 else "fused_apply: no kernel instance")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused apply runs on cpu or cuda, not {t.device}")
    return t.device.type


def residual(u, conn, qdata, basis: Basis3D, phys: Physics,
             physics: str | Pointwise = "hyperFS"):
    """Residual E-vector and stash of `physics`: (ve (3, nelem, P3),
    stash (9, nelem, Q3) or None). CPU tensors -> plain torch; CUDA ->
    kernel."""
    pw = pointwise(physics)
    if _device_kind(u) == "cpu":
        return residual_plain(u, conn, qdata, basis, phys, pw)
    nelem = conn.shape[0]
    ve = torch.empty((3, nelem, basis.P3), dtype=u.dtype, device=u.device)
    stash = (torch.empty((9, nelem, basis.Q3), dtype=u.dtype,
                         device=u.device) if pw.stash else None)
    _check(u, conn, qdata, basis, stash, pw)
    _launch(False, u, conn, qdata, basis, stash, ve, phys, pw)
    COUNTS.add("residual", basis, pw.name)
    return ve, stash


def jacobian(v, conn, qdata, stash, basis: Basis3D, phys: Physics,
             physics: str | Pointwise = "hyperFS"):
    """Jacobian action E-vector (3, nelem, P3) of `physics` from the
    stashed gradu (None for a physics without one). CPU tensors -> plain
    torch; CUDA -> kernel."""
    pw = pointwise(physics)
    if _device_kind(v) == "cpu":
        return jacobian_plain(v, conn, qdata, stash, basis, phys, pw)
    _check(v, conn, qdata, basis, stash, pw)
    ve = torch.empty((3, conn.shape[0], basis.P3), dtype=v.dtype,
                     device=v.device)
    _launch(True, v, conn, qdata, basis, stash, ve, phys, pw)
    COUNTS.add("jacobian", basis, pw.name)
    return ve
