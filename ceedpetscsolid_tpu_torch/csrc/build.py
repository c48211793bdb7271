"""Build the port's CUDA sources with nvcc into a shared library.

The kernels have a plain C interface and are loaded with ctypes
(ops/fused_apply.py), so nvcc compiles them without PyTorch's headers, in
seconds. The library goes to `build/kernels/` at the checkout root, named
by a hash of its source and flags: a changed source builds anew, an
unchanged one is reused. Building needs nvcc (PATH, $CUDA_HOME/bin or
/usr/local/cuda/bin); without it `build()` raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
SOURCES = ("fused_apply.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of ceedpetscsolid_tpu_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"cps_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile (if needed) and return (library path, compiler log).

    The log holds ptxas's per-kernel register / shared-memory / spill
    report; it is empty when an up-to-date library was reused."""
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)        # atomic: no concurrent build sees half a file
    return out, proc.stdout + proc.stderr

