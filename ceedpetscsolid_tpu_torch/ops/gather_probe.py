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
  gather_loop             (K5)  a flat grid over the output's 16-byte
                                pieces, U a thread, rows read from device
                                memory with an L2 evict_last hint, the
                                output stored streaming (any table size)
  gather_onehot           (K6)  the one-hot product's value without the
                                product: blocks (a cluster of them for a
                                tall table) count each table column's
                                non-finite values while they gather

Index contract: for any int32 index each probe gives what the JAX op of its
TPU body gives (W table rows). K3/K4 are jnp.take / take_along_axis in their
default "fill" mode: a negative index wraps once, and an index still
outside [0, W) gives a row of the canonical quiet NaN (0x7fc00000). K5 is a
lax.dynamic_slice: wrap once, then clamp into [0, W - 1]. K3-K5 copy bits
(NaN payloads, -0.0). K6 is the one-hot product (iota == idx, no wrap):
  * finite table: tab[j] + 0.0 in range (-0.0 becomes +0.0), +0.0 out of
    range;
  * out[r, c] is NaN where column c holds a non-finite value at a row
    w != j (0 * inf and 0 * NaN are NaN), or tab[j, c] is NaN; otherwise
    tab[j, c] + 0.0, so an inf survives only in the row that selects it;
  * out of range: NaN in every column that holds a non-finite value.
NaN bits: on the CPU the plain product gives JAX's, bit for bit, where a
column holds at most one non-finite value; where it holds several, the NaN
that wins follows the summation order of each library's matrix product,
which no contract fixes. On the card K6 writes CUDA's NaN (0x7fffffff), so
it is held with NaN positions equal and every other value bitwise
(`probe_equal`). Plain versions: `take_plain` (K3, K4), `slice_plain`
(K5), `onehot_plain` (K6); K3-K5 are bitwise equal to them.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Tables are float32 (W, C) with W >= 1, indices int32 (R,), as in
the script. Launch plans, cached: `plan(W, C, R)` for K3/K4, which refuses,
naming gather_loop, what does not fit a cluster; `loop_plan` (U and the
grid) for K5; `onehot_plan` for K6.

    python -m ceedpetscsolid_tpu_torch.ops.gather_probe

runs the four probes at the script's shape (512 x 128 table, 256 indices)
against the plain versions, with in-range and out-of-range indices and on
a table with non-finite values and signed zeros, times each call and its
device time, and times gather_loop (call, device, share of its bound) and
index_select at its production shape (44,928 x 26 indices into a
200,000 x 32 table). It needs a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.timing import cuda_device_ms, cuda_time_ms
from .fused_apply import H100_BYTES_PER_S

KINDS = {"take": 0, "take_along_axis": 1, "loop": 2, "onehot": 3}
STAGED = ("take", "take_along_axis")          # K3, K4: cluster-resident table
PROBE_SHAPE = (512, 256, 128)                 # W table rows, R indices, C
PRODUCTION_SHAPE = (200_000, 44_928 * 26, 32)
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
CLUSTER_MAX = 8          # the portable thread-block cluster size
CHUNK = 256              # output rows a K3/K4 block stages at once (.cu)
MIN_ROWS = 32            # output rows a K3/K4 block gets before more clusters
MAX_CLUSTERS = 16        # clusters of 8 co-resident on 132 SMs
THREADS = 256            # threads a block, every probe (.cu)
SMS = 132                # streaming multiprocessors of an H100 SXM
RESIDENT = 2048          # threads an SM keeps resident
LOOP_MAX_U = 8           # K5: most 16-byte pieces a thread
K6_MAX_NV = 32           # K6: most vectors of a column slab (.cu)
K6_NV = 4                # K6: vectors of a column slab by default
K6_BATCH = 8             # K6: scan loads in flight a thread (.cu)
QNAN_BITS = 0x7fc00000   # jnp.take's fill value, float32 bits
INT32 = np.iinfo(np.int32)


class LaunchCounts:
    """Kernel launches per probe, counted where the wrapper launches, and
    the cluster dimension of each cluster launch, K3, K4 and K6 (the last
    one per probe).
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


def onehot_matrix(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, W) one-hot matrix built by comparison, as k_onehot's iota ==
    idx: an index outside [0, W) gives a row of zeros."""
    W = tab.shape[0]
    return (torch.arange(W, device=tab.device) == idx.long()[:, None]).to(
        tab.dtype)


def onehot_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """onehot_matrix(tab, idx) @ tab: the plain version of K6, with the
    product's own rules for non-finite tables (0 * inf is NaN; exact in
    float32 with TF32 off, as problem.select_device leaves it)."""
    return onehot_matrix(tab, idx) @ tab


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
        c_int,                                 #   rows_per_cluster, per_thread
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


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """Streaming multiprocessors of device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


@dataclass(frozen=True)
class LoopPlan:
    """K5's launch: `blocks` blocks of THREADS threads, `per_thread` (U)
    pieces of `vw` floats a thread, at a stride of blocks * THREADS."""

    vw: int
    per_thread: int
    blocks: int

    @property
    def args(self) -> tuple:
        return (0, 0, 0, self.blocks, 0, self.per_thread)


@functools.lru_cache(maxsize=256)
def loop_plan(C: int, R: int, vec4: bool, sms: int = SMS) -> LoopPlan:
    """K5's plan for R rows of C floats, in 16-byte pieces when vec4 (else
    4-byte ones): U doubles, up to LOOP_MAX_U, while the pieces fill the
    card's resident threads (sms * RESIDENT) at least 2U times over, so a
    small gather spreads one piece a thread over many SMs and a large one
    keeps U loads in flight a thread."""
    vw = 4 if vec4 else 1
    pieces = R * (C // vw)
    u = 1
    while u < LOOP_MAX_U and pieces >= 2 * u * sms * RESIDENT:
        u *= 2
    return LoopPlan(vw, u, max(1, -(-pieces // (THREADS * u))))


@dataclass(frozen=True)
class OnehotPlan:
    """K6's launch: grid (cs, slabs, groups), cluster (cs, 1, 1). Block k of
    a cluster scans table rows [k rows, (k + 1) rows) of a column slab of
    `slab` columns (the last slab may be narrower); each group of clusters
    writes `rows_per_cluster` output rows."""

    vw: int
    cs: int
    rows: int
    slab: int
    slabs: int
    groups: int
    rows_per_cluster: int

    @property
    def args(self) -> tuple:
        return (self.cs, self.rows, self.slab, self.groups,
                self.rows_per_cluster, 0)


@functools.lru_cache(maxsize=256)
def onehot_plan(W: int, C: int, R: int, vec4: bool, cs: int | None = None,
                nv: int = K6_NV) -> OnehotPlan:
    """K6's plan: column slabs of `nv` vectors (16-byte when vec4, else
    4-byte; at most K6_MAX_NV); clusters of `cs` blocks (at most W), by
    default the fewest of 1, 2, 4, 8 whose blocks each scan their rows of
    the slab in one batch of K6_BATCH loads a thread (a cluster launch and
    its barriers cost more than they save on a table that small); and
    groups of clusters along the output rows, enough for about one output
    piece a thread, at most MAX_CLUSTERS * CLUSTER_MAX blocks in all. Any
    table size fits: a block keeps only its slab's counts in shared
    memory."""
    vw = 4 if vec4 else 1
    cv = C // vw
    nv = min(cv, nv, K6_MAX_NV)
    slabs = -(-cv // nv)
    if slabs > 65_535:
        raise ValueError(f"table ({W}, {C}): {slabs} column slabs exceed the "
                         "grid's y limit of 65,535")
    if cs is None:
        batch_rows = K6_BATCH * (THREADS // nv)
        cs = next((k for k in (1, 2, 4) if -(-W // k) <= batch_rows),
                  CLUSTER_MAX)
    cs = min(cs, CLUSTER_MAX, W)
    groups = max(1, min(-(-R * nv // (cs * THREADS)),
                        MAX_CLUSTERS * CLUSTER_MAX // (cs * slabs)))
    return OnehotPlan(vw, cs, -(-W // cs), nv * vw, slabs, groups,
                      -(-R // groups))


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


def _launch(kind: str, tab: torch.Tensor, idx: torch.Tensor,
            args: tuple | None = None) -> torch.Tensor:
    """Plain version on the CPU; on the card, checks, the cached plan (or
    the plan arguments `args`, as a sweep gives them) and one ctypes call,
    on the raw current stream (no torch.cuda.Stream object), switching
    devices only when tab is not on the current one."""
    dev = tab.device
    if dev.type == "cpu":
        return PLAIN[kind](tab, idx)
    if dev.type != "cuda":
        raise ValueError(f"gather probes run on cpu or cuda, not {dev}")
    _check(tab, idx)
    W, C = tab.shape
    R = idx.shape[0]
    out = torch.empty((R, C), dtype=tab.dtype, device=dev)
    if not out.numel():         # no rows or no columns: nothing to launch
        return out
    ptr = tab.data_ptr()
    vec4 = C % 4 == 0 and ptr % 16 == 0
    if kind in STAGED:
        args = args or plan(W, C, R).args + (0,)
        if ptr % 16:
            raise ValueError("tab must be 16-byte aligned for the TMA bulk "
                             "copies of the staged probes")
    elif kind == "loop":
        args = args or loop_plan(C, R, vec4, _sms(dev.index)).args
    else:
        args = args or onehot_plan(W, C, R, vec4).args
    call = (KINDS[kind], ptr, W, C, idx.data_ptr(), R, out.data_ptr(), *args,
            int(vec4), torch._C._cuda_getCurrentRawStream(dev.index))
    lib = _library(dev.index)
    if dev.index == torch.cuda.current_device():
        err = lib.cps_gather_probe(*call)
    else:
        with torch.cuda.device(dev):
            err = lib.cps_gather_probe(*call)
    if err != 0:
        raise RuntimeError(f"gather probe {kind}: cuda error {err}")
    COUNTS.launches[kind] += 1
    if kind != "loop":
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
    """K5: a dynamic row slice per index (wrap once, then clamp), U pieces
    a thread over a flat grid (loop_plan), the table kept in L2."""
    return _launch("loop", tab, idx)


def gather_onehot(tab, idx):
    """K6: the value of one_hot(idx) @ tab from the table's per-column
    counts of non-finite values, by blocks or thread-block clusters
    (onehot_plan)."""
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


# float32 bits planted by probe_inputs(nonfinite=True), a column each: inf,
# -inf, the canonical quiet NaN, a quiet NaN with a payload, a negative NaN
# and a signalling NaN
SPECIALS = (0x7F800000, 0xFF800000, 0x7FC00000, 0x7FC12345, 0xFFC00001,
            0x7FA00001)
NEG_ZERO = 0x80000000


def plant_specials(tab: np.ndarray, idx: np.ndarray,
                   rng: np.random.Generator):
    """In place: -0.0 at len(SPECIALS) seeded places, then each SPECIALS
    value at a seeded row of a column of its own (as many as C allows) and,
    where C leaves one more column, inf and a NaN with a payload in it (a
    column with two non-finite values); every planted row is put among the
    indices, at seeded places (R >= 2 len(SPECIALS) + 2)."""
    W, C = tab.shape
    bits = tab.view(np.uint32)
    zr, zc = rng.integers(0, W, len(SPECIALS)), rng.integers(0, C,
                                                            len(SPECIALS))
    bits[zr, zc] = NEG_ZERO
    n = min(C, len(SPECIALS) + 1)
    cols = rng.choice(C, n, replace=False)
    rows = rng.choice(W, n + 1, replace=W < n + 1)
    for r, c, v in zip(rows, cols, SPECIALS):
        bits[r, c] = v
    if n > len(SPECIALS):
        bits[rows[-2:], cols[-1]] = (SPECIALS[0], SPECIALS[3])
    planted = np.concatenate([zr, rows])
    idx[rng.choice(idx.shape[0], planted.shape[0], replace=False)] = planted


def probe_inputs(device, seed: int = 0, shape=PROBE_SHAPE,
                 out_of_range: bool = False, nonfinite: bool = False):
    """Seeded float32 table (W, C) and int32 indices (R,) from numpy:
    indices in [0, W), or `edge_indices` when out_of_range; with
    nonfinite, `plant_specials` puts non-finite values and signed zeros in
    the table and their rows among the indices."""
    W, R, C = shape
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((W, C)).astype(np.float32)
    idx = (edge_indices(W, R, rng) if out_of_range
           else rng.integers(0, W, R, dtype=np.int32))
    if nonfinite:
        plant_specials(tab, idx, rng)
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
    cluster-spanning one with out-of-range indices, then both again on a
    table with non-finite values and signed zeros (`plant_specials`)."""
    for shape in CHECK_SHAPES:
        yield (f"{shape}", *probe_inputs(device, seed, shape))
    for shape in CHECK_SHAPES[0], CHECK_SHAPES[3]:
        yield (f"{shape} out of range",
               *probe_inputs(device, seed, shape, out_of_range=True))
    for shape in CHECK_SHAPES[0], CHECK_SHAPES[3]:
        yield (f"{shape} non-finite, out of range",
               *probe_inputs(device, seed, shape, out_of_range=True,
                             nonfinite=True))


def probe_equal(name: str, got: torch.Tensor, ref: torch.Tensor) -> bool:
    """K3-K5: bitwise. K6: NaN positions equal and every other value
    bitwise (its NaN is CUDA's; the plain product's NaN bits follow its
    summation order)."""
    if name != "onehot":
        return torch.equal(got.view(torch.int32), ref.view(torch.int32))
    nan = got.isnan()
    return (torch.equal(nan, ref.isnan())
            and torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                            ref.masked_fill(nan, 0).view(torch.int32)))


def compare_probes(tab, idx) -> dict:
    """Each kernel against its plain version on the same inputs:
    name -> (probe_equal, max abs difference, equal values and NaN against
    NaN counted 0)."""
    out = {}
    for name, fn in PROBES.items():
        got, ref = fn(tab, idx), PLAIN[name](tab, idx)
        torch.cuda.synchronize()
        same = (got == ref) | (got.isnan() & ref.isnan())
        diff = (got - ref).abs().masked_fill(same, 0)
        out[name] = (probe_equal(name, got, ref),
                     float(diff.max()) if got.numel() else 0.0)
    return out


def bound_ms(tab, idx, whole_table: bool = False) -> float:
    """The least device ms of the gather on an H100 (3.35 TB/s): table rows
    read once (all W when whole_table, as K6 needs; else the rows that
    in-range indices touch), the indices read once, the output written
    once."""
    (W, C), R = tab.shape, idx.shape[0]
    rows = W if whole_table else int(torch.unique(idx).numel())
    return 1e3 * 4 * (rows * C + R + R * C) / H100_BYTES_PER_S


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


def time_library(tab, idx, reps: int = 20) -> dict:
    """Call and device ms of the two single PyTorch calls beside the
    probes (in-range indices): "index", the bare tab[idx]; "matmul", the
    product of the prebuilt one-hot matrix with the table (cuBLAS, TF32
    off), K6's function as one library call."""
    i, m = idx.long(), onehot_matrix(tab, idx)
    calls = {"index": lambda: tab[i], "matmul": lambda: torch.matmul(m, tab)}
    return {k: {"ms": cuda_time_ms(f, reps),
                "device_ms": cuda_device_ms(f, reps)}
            for k, f in calls.items()}


def time_production(device, reps: int = 20, seed: int = 0) -> dict:
    """gather_loop and index_select at the production shape, the data made
    on the device from `seed`: call and device ms, GB/s of gathered rows,
    gather_loop's bound (bound_ms) and its share of it."""
    W, R, C = PRODUCTION_SHAPE
    g = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn((W, C), generator=g, device=device)
    idx = torch.randint(0, W, (R,), generator=g, device=device,
                        dtype=torch.int32)
    if not torch.equal(gather_loop(tab, idx), tab.index_select(0, idx)):
        raise AssertionError("gather_loop differs from index_select at the "
                             "production shape")
    k = functools.partial(gather_loop, tab, idx)
    p = functools.partial(tab.index_select, 0, idx)
    out = {"gb": R * C * 4 / 1e9, "bound_ms": bound_ms(tab, idx),
           "ms": cuda_time_ms(k, reps), "device_ms": cuda_device_ms(k, reps),
           "plain_ms": cuda_time_ms(p, reps),
           "plain_device_ms": cuda_device_ms(p, reps)}
    out["share"] = out["bound_ms"] / out["device_ms"]
    out["gbps"] = out["gb"] / out["device_ms"] * 1e3
    out["plain_gbps"] = out["gb"] / out["plain_device_ms"] * 1e3
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device; the probes are GPU kernels",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    W, R, C = PROBE_SHAPE
    p = plan(W, C, R)
    lp = loop_plan(C, R, True, _sms(dev.index or 0))
    op = onehot_plan(W, C, R, True)
    ok = True
    print(f"probes: ({W}, {C}) float32 table, {R} int32 indices, vs the plain "
          f"versions ({torch.cuda.get_device_name(0)})")
    print(f"K3/K4 plan: cluster ({p.cs}, 1, 1), grid ({p.cs}, {C // p.slab}, "
          f"{p.groups}), {p.rows} table rows x {p.slab} columns a block, "
          f"{p.smem} B of shared memory")
    print(f"K5 plan: {lp.blocks} blocks of {THREADS}, U = {lp.per_thread}; "
          f"K6 plan: cluster ({op.cs}, 1, 1), grid ({op.cs}, {op.slabs}, "
          f"{op.groups}), {op.rows} table rows x {op.slab} columns scanned "
          "a block")
    tab, idx = probe_inputs(dev)
    times, lib = time_probes(tab, idx), time_library(tab, idx)
    for k, t in lib.items():
        print(f"library {'tab[idx]' if k == 'index' else 'onehot @ tab'}: "
              f"call {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms")
    for label, kw in (("in-range", {}), ("out-of-range", {"out_of_range": 1}),
                      ("non-finite", {"out_of_range": 1, "nonfinite": 1})):
        tab, idx = probe_inputs(dev, **kw)
        for name, (equal, err) in compare_probes(tab, idx).items():
            ok &= equal
            t = times[name]
            print(f"{'OK  ' if equal else 'FAIL'}  gather_{name:16s} "
                  f"{label:12s} equal {equal}  max|diff| {err:.3e}" + (
                      "" if kw else
                      f"  call {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}), "
                      f"device {t['device_ms']:.4f} ms (plain "
                      f"{t['plain_device_ms']:.4f})"))
    prod = time_production(dev)
    Wp, Rp, Cp = PRODUCTION_SHAPE
    print(f"production: {Rp} rows of {Cp} float32 from a ({Wp}, {Cp}) "
          f"table, {prod['gb']:.4f} GB: gather_loop call {prod['ms']:.4f} ms, "
          f"device {prod['device_ms']:.4f} ms ({prod['gbps']:.1f} GB/s), "
          f"bound {prod['bound_ms']:.4f} ms, share {prod['share']:.3f}; "
          f"index_select call {prod['plain_ms']:.4f} ms, device "
          f"{prod['plain_device_ms']:.4f} ms ({prod['plain_gbps']:.1f} GB/s)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
