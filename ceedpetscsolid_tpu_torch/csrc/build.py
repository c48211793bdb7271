"""Build the port's CUDA sources with nvcc into one shared library.

The kernels have a plain C interface and are loaded with ctypes
(ops/fused_apply.py, ops/gather_probe.py), so nvcc compiles them without
PyTorch's headers. The fused apply's template instances are split into
one translation unit per (physics, P), its generic tile into one per
(physics, body); every unit compiles in its own nvcc
process, all started together, and one nvcc call links the objects. The
library goes to `build/kernels/` at the checkout root, named by a hash of
its sources and flags: a changed source builds anew, an unchanged one is
reused. Building needs nvcc (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin);
without it `build()` raises. `build(csrc_dir, build_dir, units)` builds
the same units from another checkout's sources (utils/compare_fused.py
builds a parent commit's fused apply beside this one).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..ops.fused_apply import GENERIC_BODIES, MAX_Q, PHYSICS

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
# (source, extra flags): one compile unit each; the fused apply's template
# instance limit comes from ops/fused_apply.MAX_Q, one unit per (physics, P)
# with P = 2..MAX_Q, one unit per (physics, body) for the generic tile, plus
# the unit that holds the C entry point
_FUSED = (f"-DCPS_FUSED_MAX_Q={MAX_Q}",)
UNITS = (("fused_apply.cu", _FUSED),
         *(("fused_apply.cu", (*_FUSED, f"-DCPS_FUSED_PHYS={pw.kernel_id}",
                               f"-DCPS_FUSED_P={p}"))
           for pw in PHYSICS.values() for p in range(2, MAX_Q + 1)),
         *(("fused_apply.cu", (*_FUSED,
                               f"-DCPS_FUSED_GENERIC={pw.kernel_id}",
                               f"-DCPS_GENERIC_BODY={body}"))
           for pw in PHYSICS.values() for body in GENERIC_BODIES),
         ("gather_probe.cu", ()))
FUSED_UNITS = tuple(u for u in UNITS if u[0] == "fused_apply.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of ceedpetscsolid_tpu_torch cannot be built")


def library_path(csrc_dir: Path = CSRC, build_dir: Path = BUILD_DIR,
                 units=UNITS) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, flags in units:
        h.update(" ".join((name, *flags)).encode())
    for name in sorted({name for name, _ in units}):
        h.update((csrc_dir / name).read_bytes())
    return build_dir / f"cps_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise on the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(logs)


def build(csrc_dir: Path = CSRC, build_dir: Path = BUILD_DIR,
          units=UNITS) -> tuple[Path, str]:
    """Compile (if needed) and return (library path, compiler log).

    The log holds ptxas's per-kernel register / shared-memory / spill
    report; it is empty when an up-to-date library was reused. A copy is
    kept beside the library (<library stem>.ptxas.txt)."""
    out = library_path(csrc_dir, build_dir, units)
    if out.exists():
        return out, ""
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [build_dir / f"{tag}.{i}.o" for i in range(len(units))]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(o),
                         str(csrc_dir / name)]
                        for (name, flags), o in zip(units, objs)])
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, out)    # atomic: no concurrent build sees half a file
        out.with_suffix(".ptxas.txt").write_text(log)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out, log
