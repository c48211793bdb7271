"""Row-gather probes: four hand-written Hopper kernels for out = tab[idx].

Counterpart of scripts/try_pallas_gather.py, whose four Pallas-TPU kernels
(k_take, k_taa, k_loop, k_onehot) asked whether a row gather can run from
on-chip memory, so that the element restriction could be fused into the
element kernel. Here each is a CUDA kernel of its own design
(csrc/gather_probe.cu):

  gather_take             (K3)  table slab in shared memory, row-wise copies
  gather_take_along_axis  (K4)  table slab in shared memory, per element
  gather_loop             (K5)  indices in shared memory, rows from device
                                memory in a loop (any table size)
  gather_onehot           (K6)  one-hot tile @ table, f32 FMAs

Every kernel reproduces tab[idx] bitwise. Plain versions: `gather_plain`
(tab[idx]) for K3-K5 and `onehot_plain` (one_hot(idx) @ tab) for K6. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Tables are float32 (W, C), indices int32 (R,), as in the script.

    python -m ceedpetscsolid_tpu_torch.ops.gather_probe

runs the four probes at the script's shape (512 x 128 table, 256 indices)
against tab[idx], and times gather_loop and index_select at its production
shape (44,928 x 26 indices into a 200,000 x 32 table). It needs a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import cuda_time_ms

KINDS = {"take": 0, "take_along_axis": 1, "loop": 2, "onehot": 3}
PROBE_SHAPE = (512, 256, 128)                 # W table rows, R indices, C
PRODUCTION_SHAPE = (200_000, 44_928 * 26, 32)
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use (H100)
MAX_SLAB = 32                 # columns staged per block (K3, K4)


class LaunchCounts:
    """Kernel launches per probe, counted where the wrapper launches.
    Launch bookkeeping only: nothing reads it to decide anything."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = dict.fromkeys(KINDS, 0)


COUNTS = LaunchCounts()


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------
def gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx]: the plain version of K3, K4 and K5."""
    return tab[idx]


def onehot_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """one_hot(idx, W) @ tab: the plain version of K6 (exact in float32
    with TF32 off, as problem.select_device leaves it)."""
    return F.one_hot(idx.long(), tab.shape[0]).to(tab.dtype) @ tab


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library():
    """Build (first use) and load the kernel library."""
    from ..csrc.build import build

    path, _ = build()
    lib = ctypes.CDLL(str(path))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.cps_gather_probe.argtypes = [
        c_int, c_ptr, c_int, c_int,            # kind, tab, W, C
        c_ptr, c_int, c_ptr,                   # idx, R, out
        c_int, c_int, c_ptr,                   # slab, vec4, stream
    ]
    lib.cps_gather_probe.restype = c_int
    return lib


def slab_columns(W: int, C: int) -> int:
    """Columns a block stages for K3/K4: the widest multiple of 4 up to
    MAX_SLAB that divides C and whose W rows fit in shared memory."""
    for s in range(min(MAX_SLAB, C) // 4 * 4, 0, -4):
        if C % s == 0 and 4 * W * s <= SMEM_LIMIT:
            return s
    raise ValueError(
        f"table ({W}, {C}): no column slab fits in shared memory (a 4-column "
        f"slab of {W} rows needs {16 * W} bytes of {SMEM_LIMIT}, and C must "
        "be a multiple of 4); use gather_loop")


def _check(tab: torch.Tensor, idx: torch.Tensor):
    if tab.dtype != torch.float32:
        raise TypeError(f"tab must be float32, got {tab.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if tab.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need tab (W, C) and idx (R,), got "
                         f"{tuple(tab.shape)} and {tuple(idx.shape)}")
    if idx.device != tab.device:
        raise ValueError(f"idx on {idx.device}, expected {tab.device}")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError("tab and idx must be contiguous")
    if max(tab.shape[0] * tab.shape[1], idx.shape[0] * tab.shape[1]) >= 2**31:
        raise ValueError("table or output exceeds the kernels' int32 indexing")


def _launch(kind: str, tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if tab.device.type == "cpu":
        return (onehot_plain if kind == "onehot" else gather_plain)(tab, idx)
    if tab.device.type != "cuda":
        raise ValueError(f"gather probes run on cpu or cuda, not {tab.device}")
    _check(tab, idx)
    W, C = tab.shape
    R = idx.shape[0]
    slab = slab_columns(W, C) if kind in ("take", "take_along_axis") else 0
    if slab and tab.data_ptr() % 16:
        raise ValueError("tab must be 16-byte aligned for the staged probes")
    out = torch.empty((R, C), dtype=tab.dtype, device=tab.device)
    vec4 = int(C % 4 == 0 and tab.data_ptr() % 16 == 0)
    if R:
        with torch.cuda.device(tab.device):
            stream = torch.cuda.current_stream(tab.device).cuda_stream
            err = _library().cps_gather_probe(
                KINDS[kind], tab.data_ptr(), W, C, idx.data_ptr(), R,
                out.data_ptr(), slab, vec4, stream)
        if err != 0:
            raise RuntimeError(f"gather probe {kind}: cuda error {err}")
        COUNTS.launches[kind] += 1
    return out


def gather_take(tab, idx):
    """K3: tab[idx] from a shared-memory column slab, row-wise copies."""
    return _launch("take", tab, idx)


def gather_take_along_axis(tab, idx):
    """K4: tab[idx] from a shared-memory column slab, one thread per
    element."""
    return _launch("take_along_axis", tab, idx)


def gather_loop(tab, idx):
    """K5: tab[idx], indices in shared memory, rows read from device
    memory in a loop."""
    return _launch("loop", tab, idx)


def gather_onehot(tab, idx):
    """K6: one_hot(idx) @ tab as a hand-written f32 FMA product."""
    return _launch("onehot", tab, idx)


PROBES = {"take": gather_take, "take_along_axis": gather_take_along_axis,
          "loop": gather_loop, "onehot": gather_onehot}
PLAIN = {"take": gather_plain, "take_along_axis": gather_plain,
         "loop": gather_plain, "onehot": onehot_plain}


# ---------------------------------------------------------------------------
# the probe entry point
# ---------------------------------------------------------------------------
def probe_inputs(device, seed: int = 0, shape=PROBE_SHAPE):
    """Seeded float32 table (W, C) and int32 indices (R,) from numpy."""
    W, R, C = shape
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((W, C)).astype(np.float32)
    idx = rng.integers(0, W, R, dtype=np.int32)
    return torch.as_tensor(tab, device=device), torch.as_tensor(idx,
                                                                device=device)


def compare_probes(tab, idx) -> dict:
    """Each kernel against its plain version on the same inputs:
    name -> (bitwise equal, max abs difference)."""
    out = {}
    for name, fn in PROBES.items():
        got, ref = fn(tab, idx), PLAIN[name](tab, idx)
        torch.cuda.synchronize()
        out[name] = (torch.equal(got, ref),
                     float((got - ref).abs().max()) if got.numel() else 0.0)
    return out


def time_probes(tab, idx, reps: int = 20) -> dict:
    """name -> (kernel ms, plain ms), CUDA-event medians."""
    return {name: (cuda_time_ms(lambda fn=fn: fn(tab, idx), reps),
                   cuda_time_ms(lambda name=name: PLAIN[name](tab, idx), reps))
            for name, fn in PROBES.items()}


def time_production(device, reps: int = 20, seed: int = 0) -> dict:
    """gather_loop and plain index_select at the production shape, the
    data made on the device from `seed`: ms and GB/s of gathered rows."""
    W, R, C = PRODUCTION_SHAPE
    g = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn((W, C), generator=g, device=device)
    idx = torch.randint(0, W, (R,), generator=g, device=device,
                        dtype=torch.int32)
    if not torch.equal(gather_loop(tab, idx), tab.index_select(0, idx)):
        raise AssertionError("gather_loop differs from index_select at the "
                             "production shape")
    gb = R * C * 4 / 1e9
    ms = cuda_time_ms(lambda: gather_loop(tab, idx), reps)
    plain_ms = cuda_time_ms(lambda: tab.index_select(0, idx), reps)
    return {"gb": gb, "ms": ms, "plain_ms": plain_ms,
            "gbps": gb / ms * 1e3, "plain_gbps": gb / plain_ms * 1e3}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device; the probes are GPU kernels",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tab, idx = probe_inputs(dev)
    W, R, C = PROBE_SHAPE
    ok = True
    print(f"probes: ({W}, {C}) float32 table, {R} int32 indices, vs tab[idx] "
          f"({torch.cuda.get_device_name(0)})")
    cmp, times = compare_probes(tab, idx), time_probes(tab, idx)
    for name, (equal, err) in cmp.items():
        ok &= equal
        ms, pms = times[name]
        print(f"{'OK  ' if equal else 'FAIL'}  gather_{name:16s} bitwise "
              f"{equal}  max|diff| {err:.3e}  {ms:.4f} ms (plain {pms:.4f} ms)")
    p = time_production(dev)
    Wp, Rp, Cp = PRODUCTION_SHAPE
    print(f"production: {Rp} rows of {Cp} float32 from a ({Wp}, {Cp}) "
          f"table, {p['gb']:.4f} GB: gather_loop "
          f"{p['ms']:.4f} ms ({p['gbps']:.1f} GB/s), index_select "
          f"{p['plain_ms']:.4f} ms ({p['plain_gbps']:.1f} GB/s)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
