"""Row-gather probes: four hand-written Hopper kernels for out = tab[idx].

Counterpart of scripts/try_pallas_gather.py, whose four Pallas-TPU kernels
(k_take, k_taa, k_loop, k_onehot) asked whether a row gather can run from
on-chip memory, so that the element restriction could be fused into the
element kernel. Here each is a CUDA kernel of its own design
(csrc/gather_probe.cu):

  gather_take             (K3)  table resident in a thread-block cluster's
                                distributed shared memory, filled by TMA
                                bulk copies; row-wise 16-byte copies
  gather_take_along_axis  (K4)  the same cluster-resident table, one thread
                                per output element
  gather_loop             (K5)  indices in shared memory, rows from device
                                memory in a loop (any table size)
  gather_onehot           (K6)  one-hot tile @ table, f32 FMAs

Index contract: for any int32 index each probe gives what the JAX op of its
TPU body gives (W table rows). K3/K4 are jnp.take / take_along_axis in their
default "fill" mode: a negative index wraps once, and an index still
outside [0, W) gives a row of the canonical quiet NaN (0x7fc00000). K5 is a
lax.dynamic_slice: wrap once, then clamp into [0, W - 1]. K6 is the one-hot
product: a row of zeros outside [0, W). Plain versions, bitwise equal to
the kernels: `take_plain` (K3, K4), `slice_plain` (K5), `onehot_plain` (K6).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Tables are float32 (W, C) with W >= 1, indices int32 (R,), as in
the script. K3/K4 launch by `plan(W, C, R)`, which refuses, naming
gather_loop, what does not fit a cluster.

    python -m ceedpetscsolid_tpu_torch.ops.gather_probe

runs the four probes at the script's shape (512 x 128 table, 256 indices)
against the plain versions, with in-range and out-of-range indices, times
each call and its device time, and times gather_loop and index_select at
its production shape (44,928 x 26 indices into a 200,000 x 32 table). It
needs a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import cuda_device_ms, cuda_time_ms

KINDS = {"take": 0, "take_along_axis": 1, "loop": 2, "onehot": 3}
STAGED = ("take", "take_along_axis")          # K3, K4: cluster-resident table
PROBE_SHAPE = (512, 256, 128)                 # W table rows, R indices, C
PRODUCTION_SHAPE = (200_000, 44_928 * 26, 32)
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
CLUSTER_MAX = 8          # the portable thread-block cluster size
CHUNK = 256              # output rows a K3/K4 block stages at once (.cu)
MIN_ROWS = 32            # output rows a K3/K4 block gets before more clusters
MAX_CLUSTERS = 16        # clusters of 8 co-resident on 132 SMs
QNAN_BITS = 0x7fc00000   # jnp.take's fill value, float32 bits
INT32 = np.iinfo(np.int32)


class LaunchCounts:
    """Kernel launches per probe, counted where the wrapper launches, and
    the cluster dimension of each K3/K4 launch (the last one per probe).
    Launch bookkeeping only: nothing reads it to decide anything."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = dict.fromkeys(KINDS, 0)
        self.cluster_dims = {}


COUNTS = LaunchCounts()


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------
def _wrap(tab, idx):
    """int64 indices with a negative index wrapped once (i + W)."""
    i = idx.long()
    return torch.where(i < 0, i + tab.shape[0], i)


def take_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """jnp.take(tab, idx, axis=0) (and take_along_axis), "fill" mode: the
    plain version of K3 and K4."""
    W = tab.shape[0]
    i = _wrap(tab, idx)
    nan = torch.full((), QNAN_BITS, dtype=torch.int32,
                     device=tab.device).view(torch.float32)
    return torch.where(((i >= 0) & (i < W))[:, None], tab[i.clamp(0, W - 1)],
                       nan)


def slice_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A lax.dynamic_slice of one row per index: the plain version of K5."""
    return tab[_wrap(tab, idx).clamp(0, tab.shape[0] - 1)]


def onehot_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """one_hot(idx, W) @ tab, a zero row outside [0, W): the plain version
    of K6 (exact in float32 with TF32 off, as problem.select_device leaves
    it)."""
    W = tab.shape[0]
    i = idx.long()
    prod = F.one_hot(i.clamp(0, W - 1), W).to(tab.dtype) @ tab
    return torch.where(((i >= 0) & (i < W))[:, None], prod, prod.new_zeros(()))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _library(index: int):
    """Build (first use) and load the kernel library, and set K3/K4's
    shared-memory limit on device `index` (once per device)."""
    from ..csrc.build import build

    path, _ = build()
    lib = ctypes.CDLL(str(path))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.cps_gather_probe.argtypes = [
        c_int, c_ptr, c_int, c_int,            # kind, tab, W, C
        c_ptr, c_int, c_ptr,                   # idx, R, out
        c_int, c_int, c_int, c_int, c_int,     # plan: cs, rows, slab, groups,
                                               #   rows_per_cluster
        c_int, c_ptr,                          # vec4, stream
    ]
    lib.cps_gather_probe.restype = c_int
    lib.cps_gather_probe_init.argtypes = [c_int]
    lib.cps_gather_probe_init.restype = c_int
    with torch.cuda.device(index):
        err = lib.cps_gather_probe_init(SMEM_LIMIT)
    if err != 0:
        raise RuntimeError(f"gather probes: setting the shared-memory limit "
                           f"on cuda:{index} failed (cuda error {err})")
    return lib


@dataclass(frozen=True)
class Plan:
    """K3/K4 launch shape. A cluster of `cs` blocks holds the table: block k
    owns table rows [k rows, (k + 1) rows) of one column slab of `slab`
    columns. Grid (cs, C // slab, groups), cluster (cs, 1, 1); each group of
    clusters writes `rows_per_cluster` output rows."""

    cs: int
    rows: int
    slab: int
    groups: int
    rows_per_cluster: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a block (csrc: gp::staged_smem)."""
        return 4 * self.rows * self.slab + 4 * CHUNK + 8

    @property
    def args(self) -> tuple:
        return (self.cs, self.rows, self.slab, self.groups,
                self.rows_per_cluster)


@functools.lru_cache(maxsize=256)
def plan(W: int, C: int, R: int) -> Plan:
    """K3/K4's launch plan for a (W, C) table and R indices: the largest
    portable cluster (at most W blocks), the widest column slab (a multiple
    of 4 dividing C) whose rows fit in a block's shared memory, and clusters
    along the output rows (at least MIN_ROWS a block, at most MAX_CLUSTERS
    in all). Raises ValueError, naming gather_loop, where none fits."""
    if C % 4 or W < 1:
        raise ValueError(
            f"table ({W}, {C}): the staged probes need W >= 1 and C a "
            "multiple of 4 (TMA bulk copies move multiples of 16 bytes); use "
            "gather_loop")
    cs = min(CLUSTER_MAX, W)
    rows = -(-W // cs)
    fit = (SMEM_LIMIT - 4 * CHUNK - 8) // (4 * rows)      # columns that fit
    slab = next((s for s in range(min(C, fit) // 4 * 4, 0, -4) if C % s == 0),
                0)
    if not slab:
        raise ValueError(
            f"table ({W}, {C}): a 4-column slab of {rows} rows a block (a "
            f"cluster of {cs}) needs {16 * rows + 4 * CHUNK + 8} bytes of "
            f"shared memory, more than {SMEM_LIMIT}; use gather_loop")
    groups = max(1, min(-(-R // (cs * MIN_ROWS)), MAX_CLUSTERS // (C // slab)))
    return Plan(cs, rows, slab, groups, -(-R // groups))


def _check(tab: torch.Tensor, idx: torch.Tensor):
    if tab.dtype != torch.float32:
        raise TypeError(f"tab must be float32, got {tab.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if tab.dim() != 2 or idx.dim() != 1 or tab.shape[0] < 1:
        raise ValueError(f"need tab (W, C) with W >= 1 and idx (R,), got "
                         f"{tuple(tab.shape)} and {tuple(idx.shape)}")
    if idx.device != tab.device:
        raise ValueError(f"idx on {idx.device}, expected {tab.device}")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError("tab and idx must be contiguous")
    if max(tab.shape[0] * tab.shape[1], idx.shape[0] * tab.shape[1]) >= 2**31:
        raise ValueError("table or output exceeds the kernels' int32 indexing")


def _launch(kind: str, tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version on the CPU; on the card, checks, the cached plan and
    one ctypes call, on the raw current stream (no torch.cuda.Stream
    object), switching devices only when tab is not on the current one."""
    dev = tab.device
    if dev.type == "cpu":
        return PLAIN[kind](tab, idx)
    if dev.type != "cuda":
        raise ValueError(f"gather probes run on cpu or cuda, not {dev}")
    _check(tab, idx)
    W, C = tab.shape
    R = idx.shape[0]
    out = torch.empty((R, C), dtype=tab.dtype, device=dev)
    if not R:
        return out
    ptr = tab.data_ptr()
    args = (0,) * 5
    if kind in STAGED:
        args = plan(W, C, R).args
        if ptr % 16:
            raise ValueError("tab must be 16-byte aligned for the TMA bulk "
                             "copies of the staged probes")
    call = (KINDS[kind], ptr, W, C, idx.data_ptr(), R, out.data_ptr(), *args,
            int(C % 4 == 0 and ptr % 16 == 0),
            torch._C._cuda_getCurrentRawStream(dev.index))
    lib = _library(dev.index)
    if dev.index == torch.cuda.current_device():
        err = lib.cps_gather_probe(*call)
    else:
        with torch.cuda.device(dev):
            err = lib.cps_gather_probe(*call)
    if err != 0:
        raise RuntimeError(f"gather probe {kind}: cuda error {err}")
    COUNTS.launches[kind] += 1
    if kind in STAGED:
        COUNTS.cluster_dims[kind] = (args[0], 1, 1)
    return out


def gather_take(tab, idx):
    """K3: jnp.take(tab, idx, axis=0) from a cluster-resident table,
    row-wise copies."""
    return _launch("take", tab, idx)


def gather_take_along_axis(tab, idx):
    """K4: take_along_axis of tab by idx broadcast over the columns, from a
    cluster-resident table, one thread per element."""
    return _launch("take_along_axis", tab, idx)


def gather_loop(tab, idx):
    """K5: a dynamic row slice per index, indices in shared memory, rows
    read from device memory in a loop."""
    return _launch("loop", tab, idx)


def gather_onehot(tab, idx):
    """K6: one_hot(idx) @ tab as a hand-written f32 FMA product."""
    return _launch("onehot", tab, idx)


PROBES = {"take": gather_take, "take_along_axis": gather_take_along_axis,
          "loop": gather_loop, "onehot": gather_onehot}
PLAIN = {"take": take_plain, "take_along_axis": take_plain,
         "loop": slice_plain, "onehot": onehot_plain}


# ---------------------------------------------------------------------------
# the probe entry point
# ---------------------------------------------------------------------------
def edge_indices(W: int, R: int, rng: np.random.Generator) -> np.ndarray:
    """int32 indices drawn from [-2W, 2W), with 0, W-1, -1, -W, W, W+7,
    -W-1 and the int32 extremes put at seeded places (R >= 9)."""
    idx = rng.integers(-2 * W, 2 * W, R, dtype=np.int64)
    edge = [0, W - 1, -1, -W, W, W + 7, -W - 1, INT32.min, INT32.max]
    idx[rng.choice(R, len(edge), replace=False)] = edge
    return idx.astype(np.int32)


def probe_inputs(device, seed: int = 0, shape=PROBE_SHAPE,
                 out_of_range: bool = False):
    """Seeded float32 table (W, C) and int32 indices (R,) from numpy:
    indices in [0, W), or `edge_indices` when out_of_range."""
    W, R, C = shape
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((W, C)).astype(np.float32)
    idx = (edge_indices(W, R, rng) if out_of_range
           else rng.integers(0, W, R, dtype=np.int32))
    return torch.as_tensor(tab, device=device), torch.as_tensor(idx,
                                                                device=device)


# (W, R, C) of the kernel-vs-plain checks: the script's shape, a ragged one
# (partial row blocks and tiles), a narrow table, one that spans a cluster
# (512 KB, 64 KB a block) and one cut into four column slabs (4 MB)
CHECK_SHAPES = (PROBE_SHAPE, (100, 300, 36), (700, 1000, 8),
                (2000, 4096, 64), (4000, 512, 256))


def probe_cases(device, seed: int = 1):
    """(label, tab, idx) of every kernel-vs-plain check: each CHECK_SHAPES
    entry with indices in range, then the script's shape and the
    cluster-spanning one with out-of-range indices."""
    for shape in CHECK_SHAPES:
        yield (f"{shape}", *probe_inputs(device, seed, shape))
    for shape in CHECK_SHAPES[0], CHECK_SHAPES[3]:
        yield (f"{shape} out of range",
               *probe_inputs(device, seed, shape, out_of_range=True))


def compare_probes(tab, idx) -> dict:
    """Each kernel against its plain version on the same inputs:
    name -> (bitwise equal, max abs difference, NaN rows counted equal)."""
    out = {}
    for name, fn in PROBES.items():
        got, ref = fn(tab, idx), PLAIN[name](tab, idx)
        torch.cuda.synchronize()
        diff = (got - ref).abs().masked_fill(got.isnan() & ref.isnan(), 0)
        out[name] = (torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                     float(diff.max()) if got.numel() else 0.0)
    return out


def time_probes(tab, idx, reps: int = 20) -> dict:
    """name -> {"ms", "plain_ms"}: CUDA-event medians of one call, the
    host's enqueue included; {"device_ms", "plain_device_ms"}: the device
    alone (utils.timing.cuda_device_ms)."""
    out = {}
    for name, fn in PROBES.items():
        k = functools.partial(fn, tab, idx)
        p = functools.partial(PLAIN[name], tab, idx)
        out[name] = {"ms": cuda_time_ms(k, reps),
                     "plain_ms": cuda_time_ms(p, reps),
                     "device_ms": cuda_device_ms(k, reps),
                     "plain_device_ms": cuda_device_ms(p, reps)}
    return out


def time_index(tab, idx, reps: int = 20) -> dict:
    """Call and device ms of the bare tab[idx], the gather the plain
    versions add their index handling to (in-range indices only)."""
    i = idx.long()
    return {"ms": cuda_time_ms(lambda: tab[i], reps),
            "device_ms": cuda_device_ms(lambda: tab[i], reps)}


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
    W, R, C = PROBE_SHAPE
    p = plan(W, C, R)
    ok = True
    print(f"probes: ({W}, {C}) float32 table, {R} int32 indices, vs the plain "
          f"versions ({torch.cuda.get_device_name(0)})")
    print(f"K3/K4 plan: cluster ({p.cs}, 1, 1), grid ({p.cs}, {C // p.slab}, "
          f"{p.groups}), {p.rows} table rows x {p.slab} columns a block, "
          f"{p.smem} B of shared memory")
    tab, idx = probe_inputs(dev)
    times, bare = time_probes(tab, idx), time_index(tab, idx)
    print(f"bare tab[idx]: call {bare['ms']:.4f} ms, device "
          f"{bare['device_ms']:.4f} ms")
    for oor in (False, True):
        tab, idx = probe_inputs(dev, out_of_range=oor)
        for name, (equal, err) in compare_probes(tab, idx).items():
            ok &= equal
            t = times[name]
            print(f"{'OK  ' if equal else 'FAIL'}  gather_{name:16s} "
                  f"{'out-of-range' if oor else 'in-range'} bitwise {equal}  "
                  f"max|diff| {err:.3e}" + ("" if oor else
                  f"  call {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}), "
                  f"device {t['device_ms']:.4f} ms (plain "
                  f"{t['plain_device_ms']:.4f})"))
    prod = time_production(dev)
    Wp, Rp, Cp = PRODUCTION_SHAPE
    print(f"production: {Rp} rows of {Cp} float32 from a ({Wp}, {Cp}) "
          f"table, {prod['gb']:.4f} GB: gather_loop "
          f"{prod['ms']:.4f} ms ({prod['gbps']:.1f} GB/s), index_select "
          f"{prod['plain_ms']:.4f} ms ({prod['plain_gbps']:.1f} GB/s)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
