"""ctypes binding of the native smoothed-aggregation AMG setup (csrc/amg.cpp).

Port of ceedpetscsolid_tpu/native/__init__.py. The C++ source is the
repository's own `csrc/amg.cpp`, compiled as it is at first use with
`g++ -O3 -shared -fPIC -std=c++17` into `build/native/` at the checkout
root (gitignored), named by a hash of the source and the flags: a changed
source builds anew, an unchanged one is reused. The same happens on the GPU
machine and on the CPU. A failed build raises; there is no other AMG.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "csrc" / "amg.cpp"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libamg_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/amg.cpp (if needed); return the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE} "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)    # atomic: no concurrent build sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """Build (first use) and load the AMG library, with its signatures."""
    L = ctypes.CDLL(str(build()))
    i64 = np.ctypeslib.ndpointer(np.int64)
    i32 = np.ctypeslib.ndpointer(np.int32)
    f64 = np.ctypeslib.ndpointer(np.float64)
    vp = ctypes.c_void_p
    L.amg_setup.restype = vp
    L.amg_setup.argtypes = [ctypes.c_int, ctypes.c_int64, i64, i32, f64,
                            ctypes.c_double, ctypes.c_int, ctypes.c_int]
    L.amg_refresh.argtypes = [vp, f64]
    L.amg_num_levels.restype = ctypes.c_int
    L.amg_num_levels.argtypes = [vp]
    L.amg_level_dims.argtypes = [vp, ctypes.c_int, i64]
    L.amg_get_matrix.argtypes = [vp, ctypes.c_int, i64, i32, f64, f64, f64]
    L.amg_get_prolongator.argtypes = [vp, ctypes.c_int, i64, i32, f64]
    L.amg_coarse_dense.argtypes = [vp, f64]
    L.amg_free.argtypes = [vp]
    return L
