"""Fused hyperFS element apply: gather -> B -> physics -> B^T, per element.

Counterpart of ceedpetscsolid_tpu/ops/pallas_apply.py (the TPU kernel
`_apply_kernel` built by `make_fused_apply`). Two implementations of one
function:

  * `residual_plain` / `jacobian_plain`: plain torch (conn gather, Kronecker
    einsum, Mat3 physics, adjoint einsum). The CPU path and the reference
    the kernel is tested against.
  * the CUDA kernel in csrc/fused_apply.cu, launched by `residual` /
    `jacobian` for tensors on a CUDA device.

`residual` and `jacobian` choose by the device of their input: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel, and raises if
the kernel cannot be built or has no instance for its (P, Q, dtype). There
is no fallback from CUDA to the plain version.

Outputs are E-vectors (3, nelem, P3); the owner-sum to the L-vector is
ops/restriction.Restriction.scatter_add. The stash is one contiguous
(9, nelem, Q3) tensor: plane 3c+k holds gradu[c, k].
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models import hyper_fs
from ..models.base import Mat3, Physics
from .basis import Basis3D

# (P, Q) instances compiled into the kernel library: every 2 <= P <= Q <= 6,
# i.e. degrees 1-5 at their own Gauss rule and every coarser p-multigrid
# level at a finer level's rule. The one place the limit is set:
# csrc/build.py passes it to nvcc as -DCPS_FUSED_MAX_Q.
MAX_Q = 6
INSTANTIATED_PQ = frozenset((P, Q) for Q in range(2, MAX_Q + 1)
                            for P in range(2, Q + 1))
_DTYPES = {torch.float32: 0, torch.float64: 1}


class LaunchCounts:
    """Kernel launches per mode, and per (mode, P, Q), counted where the
    wrapper launches. Launch bookkeeping only: nothing reads it to decide
    anything."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.residual_launches = 0
        self.jacobian_launches = 0
        self.by_pq = {}             # ("residual" | "jacobian", P, Q) -> n

    def add(self, mode: str, basis: Basis3D):
        if mode == "residual":
            self.residual_launches += 1
        else:
            self.jacobian_launches += 1
        key = (mode, basis.P, basis.Q)
        self.by_pq[key] = self.by_pq.get(key, 0) + 1


COUNTS = LaunchCounts()


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------
def residual_plain(u, conn, qdata, basis: Basis3D, phys: Physics):
    """(u (3, N), conn (nelem, P3), qdata (10, nelem, Q3)) ->
    (ve (3, nelem, P3), stash (9, nelem, Q3))."""
    du = basis.apply_grad(u[:, conn])                     # (3, 3, e, Q3)
    dv, gradu = hyper_fs.residual_planes(Mat3.from_array(du), qdata, phys)
    return basis.apply_grad_T(dv.to_array()), torch.stack(gradu.m)


def jacobian_plain(v, conn, qdata, stash, basis: Basis3D, phys: Physics):
    """(v (3, N), ..., stash (9, nelem, Q3)) -> J.v E-vector (3, nelem, P3)."""
    ddu = basis.apply_grad(v[:, conn])
    dv = hyper_fs.jacobian_planes(Mat3.from_array(ddu), qdata,
                                  Mat3(stash.unbind(0)), phys)
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
        c_int, c_int, c_int, c_int,            # jacobian, P, Q, is_double
        c_ptr, ctypes.c_longlong, c_ptr, c_int,   # u, N, conn, nelem
        c_ptr, c_ptr, c_ptr,                   # qdata, B, D
        c_ptr, c_ptr,                          # stash, ve
        ctypes.c_double, ctypes.c_double,      # lam, mu
        c_ptr,                                 # stream
    ]
    lib.cps_fused_apply.restype = c_int
    return lib


def _check(u, conn, qdata, basis: Basis3D, stash):
    """Validate what the kernel takes; raise on anything else."""
    dev, dt = u.device, u.dtype
    P, Q = basis.P, basis.Q
    if (P, Q) not in INSTANTIATED_PQ:
        raise NotImplementedError(
            f"fused CUDA apply has no instance for P={P}, Q={Q} "
            f"(instances: every 2 <= P <= Q <= {MAX_Q})")
    if dt not in _DTYPES:
        raise TypeError(f"fused CUDA apply takes float32/float64, got {dt}")
    nelem = conn.shape[0]
    expect = {
        "u": (u, (3, u.shape[1]), dt),
        "conn": (conn, (nelem, P ** 3), torch.int64),
        "qdata": (qdata, (10, nelem, Q ** 3), dt),
        "stash": (stash, (9, nelem, Q ** 3), dt),
        "basis.B": (basis.B, (Q, P), dt),
        "basis.D": (basis.D, (Q, P), dt),
    }
    for name, (t, shape, tdt) in expect.items():
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


def _launch(jacobian: bool, u, conn, qdata, basis, stash, ve, phys):
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.cps_fused_apply(
            int(jacobian), basis.P, basis.Q, _DTYPES[u.dtype],
            u.data_ptr(), u.shape[1], conn.data_ptr(), conn.shape[0],
            qdata.data_ptr(), basis.B.data_ptr(), basis.D.data_ptr(),
            stash.data_ptr(), ve.data_ptr(), float(phys.lam), float(phys.mu),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_apply kernel launch failed: cuda error {err}"
                           if err > 0 else "fused_apply: no kernel instance")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused apply runs on cpu or cuda, not {t.device}")
    return t.device.type


def residual(u, conn, qdata, basis: Basis3D, phys: Physics):
    """hyperFS residual E-vector and stash: (ve (3, nelem, P3),
    stash (9, nelem, Q3)). CPU tensors -> plain torch; CUDA -> kernel."""
    if _device_kind(u) == "cpu":
        return residual_plain(u, conn, qdata, basis, phys)
    nelem = conn.shape[0]
    ve = torch.empty((3, nelem, basis.P3), dtype=u.dtype, device=u.device)
    stash = torch.empty((9, nelem, basis.Q3), dtype=u.dtype, device=u.device)
    _check(u, conn, qdata, basis, stash)
    _launch(False, u, conn, qdata, basis, stash, ve, phys)
    COUNTS.add("residual", basis)
    return ve, stash


def jacobian(v, conn, qdata, stash, basis: Basis3D, phys: Physics):
    """hyperFS Jacobian action E-vector (3, nelem, P3) from the stashed
    gradu. CPU tensors -> plain torch; CUDA -> kernel."""
    if _device_kind(v) == "cpu":
        return jacobian_plain(v, conn, qdata, stash, basis, phys)
    _check(v, conn, qdata, basis, stash)
    ve = torch.empty((3, conn.shape[0], basis.P3), dtype=v.dtype,
                     device=v.device)
    _launch(True, v, conn, qdata, basis, stash, ve, phys)
    COUNTS.add("jacobian", basis)
    return ve
