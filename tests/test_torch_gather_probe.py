"""The row-gather probes (ops/gather_probe.py) on the CPU.

The JAX probe kernels of scripts/try_pallas_gather.py are closures inside
its main() that need TPU memory spaces, so they cannot be called here. The
oracle is the JAX op of each body, evaluated by JAX on the CPU:
jnp.take (k_take), jnp.take_along_axis (k_taa), lax.dynamic_slice per row
(k_loop's pl.ds) and the iota one-hot product (k_onehot), and for indices
in range the script's own reference, np.asarray(tab)[np.asarray(idx)] (its
line 41). The plain versions, and the wrappers on CPU tensors, must equal
it bitwise, NaN rows included; on tables with non-finite values the
one-hot product's NaN bits are pinned where a column holds at most one
non-finite value (elsewhere they follow each library's summation order).
The kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py (K6 with NaN positions equal, the rest bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ceedpetscsolid_tpu_torch.ops import gather_probe as gp


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


JAX_OPS = {
    "take": lambda t, i: jnp.take(t, i, axis=0),
    "take_along_axis": lambda t, i: jnp.take_along_axis(
        t, jnp.broadcast_to(i[:, None], (i.shape[0], t.shape[1])), axis=0),
    "loop": lambda t, i: jax.vmap(lambda j: lax.dynamic_slice(
        t, (j, jnp.int32(0)), (1, t.shape[1]))[0])(i),
    "onehot": lambda t, i: jnp.dot(
        (lax.broadcasted_iota(jnp.int32, (i.shape[0], t.shape[0]), 1)
         == i[:, None]).astype(jnp.float32), t,
        preferred_element_type=jnp.float32),
}


@pytest.mark.parametrize("shape", [(64, 200, 16), gp.PROBE_SHAPE])
@pytest.mark.parametrize("name", list(gp.KINDS))
def test_probe_semantics_match_jax(name, shape):
    """Indices drawn from [-2W, 2W) with 0, W-1, -1, -W, W, W+7, -W-1 and
    the int32 extremes mixed in: plain version and CPU wrapper bitwise equal
    to the JAX op of the probe's TPU body (wrap once then NaN fill, clamp,
    or zero rows)."""
    tab, idx = gp.probe_inputs("cpu", seed=5, shape=shape, out_of_range=True)
    W = shape[0]
    i = idx.numpy()
    assert {0, W - 1, -1, -W, W, W + 7, -W - 1} <= set(i.tolist())
    ref = _bits(JAX_OPS[name](jnp.asarray(tab.numpy()), jnp.asarray(i)))
    assert ref.shape == (shape[1], shape[2])
    assert np.array_equal(_bits(gp.PLAIN[name](tab, idx)), ref)
    assert np.array_equal(_bits(gp.PROBES[name](tab, idx)), ref)
    # the contract, spelled out: which rows are NaN, clamped or zero
    j = np.where(i < 0, i.astype(np.int64) + W, i)
    inside = (j >= 0) & (j < W)
    out = gp.PLAIN[name](tab, idx).numpy()
    if name in gp.STAGED:
        assert np.isnan(out[~inside]).all() and not np.isnan(out[inside]).any()
        assert (_bits(out[~inside]) == gp.QNAN_BITS).all()
    elif name == "loop":
        assert np.array_equal(out, tab.numpy()[np.clip(j, 0, W - 1)])
    else:
        assert not out[~inside].any()


@pytest.mark.parametrize("shape", [gp.PROBE_SHAPE, (100, 300, 36),
                                   (20_000, 4_000, 32)])
@pytest.mark.parametrize("name", list(gp.KINDS))
def test_plain_versions_equal_script_reference(name, shape):
    """Every plain version (and the wrapper on CPU tensors) is bitwise
    np.asarray(tab)[np.asarray(idx)] for indices in range; W, R, C = shape."""
    tab, idx = gp.probe_inputs("cpu", seed=3, shape=shape)
    ref = tab.numpy()[idx.numpy()]
    assert np.array_equal(gp.PLAIN[name](tab, idx).numpy(), ref)
    assert np.array_equal(gp.PROBES[name](tab, idx).numpy(), ref)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors no kernel is launched (and none is counted)."""
    tab, idx = gp.probe_inputs("cpu")
    gp.COUNTS.reset()
    for fn in gp.PROBES.values():
        fn(tab, idx)
    assert set(gp.COUNTS.launches.values()) == {0}
    assert gp.COUNTS.cluster_dims == {}


def test_probe_inputs_are_the_script_shapes():
    tab, idx = gp.probe_inputs("cpu")
    assert tab.shape == (512, 128) and tab.dtype == torch.float32
    assert idx.shape == (256,) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 512
    _, edge = gp.probe_inputs("cpu", out_of_range=True)
    assert edge.dtype == torch.int32
    assert {-2**31, 2**31 - 1} <= set(edge.tolist())
    W, R, C = gp.PRODUCTION_SHAPE
    assert (W, R, C) == (200_000, 44_928 * 26, 32)


def _nan_or_bits_equal(a, b) -> bool:
    """NaN positions equal and every other value bitwise."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return (np.array_equal(nan, np.isnan(b))
            and np.array_equal(_bits(np.where(nan, 0, a)),
                               _bits(np.where(nan, 0, b))))


def _onehot_rule(tab: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """K6's rule as csrc/gather_probe.cu computes it: NaN where the column
    holds a non-finite value at another row than j (any row when j is out
    of range), else tab[j] + 0.0 (+0.0 out of range)."""
    W = tab.shape[0]
    nf = ~np.isfinite(tab)
    j = np.clip(idx, 0, W - 1)
    inside = ((idx >= 0) & (idx < W))[:, None]
    row = np.where(inside, tab[j], np.float32(0))
    others = nf.sum(0)[None, :] - (inside & nf[j])
    with np.errstate(invalid="ignore"):     # a signalling NaN + 0.0
        return np.where(others > 0, np.float32(np.nan), row + np.float32(0))


@pytest.mark.parametrize("shape", [(64, 200, 16), gp.PROBE_SHAPE,
                                   (100, 300, 36), (50, 40, 3)])
@pytest.mark.parametrize("name", list(gp.KINDS))
def test_nonfinite_semantics_match_jax(name, shape):
    """Tables with inf, -inf, NaNs (canonical, with a payload, negative,
    signalling) and -0.0 at seeded places, their rows among in-range and
    out-of-range indices: K3-K5's plain versions and CPU wrappers bitwise
    equal to the JAX op, payloads and signed zeros kept. K6's one-hot
    product bitwise equal to JAX's on every column that holds at most one
    non-finite value, and NaN positions equal (every other value bitwise)
    on all; JAX's answer also follows the counting rule the CUDA kernel
    computes. (The tree before the repair gave 0, not NaN, in out-of-range
    rows of a column with a non-finite value.)"""
    tab, idx = gp.probe_inputs("cpu", seed=11, shape=shape, out_of_range=True,
                               nonfinite=True)
    t, i = tab.numpy(), idx.numpy()
    bits = t.view(np.uint32)
    assert not np.isfinite(t).all() and (bits == gp.NEG_ZERO).any()
    ref = np.asarray(JAX_OPS[name](jnp.asarray(t), jnp.asarray(i)))
    for got in (gp.PLAIN[name](tab, idx).numpy(),
                gp.PROBES[name](tab, idx).numpy()):
        if name != "onehot":
            assert np.array_equal(_bits(got), _bits(ref))
            continue
        one = (~np.isfinite(t)).sum(0) <= 1
        assert np.array_equal(_bits(got[:, one]), _bits(ref[:, one]))
        assert _nan_or_bits_equal(got, ref)
    if name == "onehot":
        assert _nan_or_bits_equal(_onehot_rule(t, i), ref)
        outside = (i < 0) | (i >= t.shape[0])
        assert outside.any() and np.isnan(ref[outside][:, ~np.isfinite(
            t).all(0)]).all()


def test_onehot_plain_nonfinite_example():
    """An 8 x 4 table with inf at (2, 1), NaN at (3, 2) and -0.0 at (1, 0),
    indices [1, 2, 3, 4, 9, -1], spelled out: in range, the column with the
    inf gives inf only in the row that selects it and NaN elsewhere, the
    NaN column NaN everywhere, -0.0 comes out +0.0; out of range (9, -1),
    NaN in columns 1 and 2 and +0.0 in columns 0 and 3, as JAX gives."""
    t = np.arange(32, dtype=np.float32).reshape(8, 4) + 1
    t[2, 1], t[3, 2], t[1, 0] = np.inf, np.nan, -0.0
    i = np.array([1, 2, 3, 4, 9, -1], dtype=np.int32)
    got = gp.onehot_plain(torch.as_tensor(t), torch.as_tensor(i)).numpy()
    nan = np.float32(np.nan)
    want = np.array([[0.0, nan, nan, 8.0], [9.0, np.inf, nan, 12.0],
                     [13.0, nan, nan, 16.0], [17.0, nan, nan, 20.0],
                     [0.0, nan, nan, 0.0], [0.0, nan, nan, 0.0]],
                    dtype=np.float32)
    assert _nan_or_bits_equal(got, want)
    ref = JAX_OPS["onehot"](jnp.asarray(t), jnp.asarray(i))
    assert np.array_equal(_bits(got), _bits(ref))


def test_plant_specials():
    """probe_inputs(nonfinite=True): every special value in the table, one
    column with two non-finite values, and their rows among the indices."""
    tab, idx = gp.probe_inputs("cpu", seed=4, shape=(64, 200, 16),
                               nonfinite=True)
    bits = tab.numpy().view(np.uint32)
    assert set(gp.SPECIALS) | {gp.NEG_ZERO} <= set(bits.ravel().tolist())
    nf = ~np.isfinite(tab.numpy())
    assert sorted(nf.sum(0)[nf.sum(0) > 0]) == [1] * 6 + [2]
    assert set(np.nonzero(nf)[0]) <= set(idx.tolist())
    assert ((idx >= 0) & (idx < 64)).all()


def test_probe_equal():
    """The card's comparison: K3-K5 bitwise (a NaN payload or a zero's sign
    counts), K6 NaN positions equal and every other value bitwise."""
    a = torch.tensor([[1.0, 0.0, float("nan")]])
    b = a.clone()
    b.view(torch.int32)[0, 2] = 0x7fffffff
    assert gp.probe_equal("onehot", a, b)
    assert not gp.probe_equal("loop", a, b)
    c = a.clone()
    c[0, 1] = -0.0
    assert not gp.probe_equal("onehot", a, c)
    assert not gp.probe_equal("onehot", a, torch.zeros_like(a))
    assert gp.probe_equal("take", a, a.clone())


def test_bound_ms():
    """Bytes over 3.35 TB/s: the rows the indices touch (all W for K6), the
    indices and the output, four bytes each."""
    tab, idx = gp.probe_inputs("cpu")
    W, R, C = gp.PROBE_SHAPE
    rows = len(set(idx.tolist()))
    assert gp.bound_ms(tab, idx) == pytest.approx(
        1e3 * 4 * (rows * C + R + R * C) / 3.35e12)
    assert gp.bound_ms(tab, idx, whole_table=True) == pytest.approx(
        1e3 * 4 * (W * C + R + R * C) / 3.35e12)


# (C, R, vec4) -> (U, blocks): the probe, the production shape, ragged R
@pytest.mark.parametrize("C,R,vec4,expect", [
    (128, 256, True, (1, 32)),                      # the probe: 32 SMs
    (32, 44_928 * 26, True, (8, 4563)),             # production: U = 8
    (128, 1, True, (1, 1)),
    (128, 9, True, (1, 2)),
    (128, 257, True, (1, 33)),
    (3, 257, False, (1, 4)),                        # the scalar path
    (128, 256, False, (1, 128)),                    # misaligned: 4 bytes
    (32, 70_000, True, (2, 1094)),
    (32, 140_000, True, (4, 1094)),
])
def test_loop_plan(C, R, vec4, expect):
    """K5's plan: U doubles (to 8) while the pieces fill the card's
    resident threads 2U times over; the grid covers every piece once."""
    p = gp.loop_plan(C, R, vec4)
    assert (p.per_thread, p.blocks) == expect
    pieces = R * C // p.vw
    assert p.vw == (4 if vec4 else 1)
    assert p.blocks * gp.THREADS * p.per_thread >= pieces
    assert (p.blocks - 1) * gp.THREADS * p.per_thread < max(pieces, 1)
    assert p.args == (0, 0, 0, p.blocks, 0, p.per_thread)


# (W, C, R, vec4) -> (cs, rows, slab, slabs, groups, rows per cluster)
@pytest.mark.parametrize("W,C,R,vec4,expect", [
    (512, 128, 256, True, (1, 512, 16, 8, 4, 64)),     # the probe: 32 blocks
    (200_000, 32, 44_928 * 26, True, (8, 25_000, 16, 2, 8, 146_016)),
    (512, 128, 1, True, (1, 512, 16, 8, 1, 1)),
    (512, 128, 9, True, (1, 512, 16, 8, 1, 9)),
    (512, 128, 257, True, (1, 512, 16, 8, 5, 52)),
    (2000, 64, 4096, True, (4, 500, 16, 4, 8, 512)),   # a cluster of 4
    (4000, 256, 512, True, (8, 500, 16, 16, 1, 512)),  # 128 blocks
    (600, 260, 70, True, (2, 300, 16, 17, 1, 70)),     # a narrower last slab
    (50, 3, 257, False, (1, 50, 3, 1, 4, 65)),         # the scalar path
    (512, 128, 256, False, (1, 512, 4, 32, 4, 64)),    # misaligned table
    (3, 8, 10, True, (1, 3, 8, 1, 1, 10)),
])
def test_onehot_plan(W, C, R, vec4, expect):
    """K6's plan: slabs of 4 vectors, the fewest blocks a cluster (1, 2, 4
    or 8) whose rows each thread scans in one batch of K6_BATCH loads, and
    groups of clusters for about one output piece a thread, at most 128
    blocks; any table size (no shared-memory refusal)."""
    p = gp.onehot_plan(W, C, R, vec4)
    assert (p.cs, p.rows, p.slab, p.slabs, p.groups,
            p.rows_per_cluster) == expect
    assert p.cs * p.rows >= W and p.slabs * p.slab >= C
    assert p.slab % p.vw == 0 and p.slab // p.vw <= gp.K6_MAX_NV
    assert p.groups * p.rows_per_cluster >= R
    assert p.groups == 1 or (p.groups * p.slabs * p.cs
                             <= gp.MAX_CLUSTERS * gp.CLUSTER_MAX)
    one_batch = p.rows * (p.slab // p.vw) <= gp.K6_BATCH * gp.THREADS
    assert one_batch or p.cs == gp.CLUSTER_MAX
    assert p.args == (p.cs, p.rows, p.slab, p.groups, p.rows_per_cluster, 0)


@pytest.mark.parametrize("cs,nv", [(8, 32), (2, 8), (1, 4)])
def test_onehot_plan_given_cluster_and_slab(cs, nv):
    """A sweep's plan: the cluster size and slab width as given (capped by
    W and 32 vectors), the rest by the same rules."""
    p = gp.onehot_plan(512, 128, 256, True, cs, nv)
    assert (p.cs, p.slab) == (cs, 4 * nv)
    assert p.cs * p.slabs * p.groups == 32
    assert gp.onehot_plan(3, 128, 256, True, 8, 64).cs == 3
    assert gp.onehot_plan(3, 256, 256, True, 8, 64).slab == 128


def test_probe_cases_on_cpu():
    """The kernel-vs-plain cases of the card (gather_probe.probe_cases):
    every shape plans, and on CPU tensors each wrapper is its plain
    version, tab[idx] where the indices are in range."""
    labels = []
    for label, tab, idx in gp.probe_cases("cpu"):
        labels.append(label)
        (W, C), R = tab.shape, idx.shape[0]
        gp.plan(W, C, R)
        inside = bool(((idx >= 0) & (idx < W)).all())
        for name, fn in gp.PROBES.items():
            got = fn(tab, idx).numpy()
            assert np.array_equal(_bits(got), _bits(gp.PLAIN[name](tab, idx)))
            if inside:
                assert np.array_equal(got, tab.numpy()[idx.numpy()])
    assert len(labels) == len(gp.CHECK_SHAPES) + 4
    assert sum("out of range" in s for s in labels) == 4
    assert sum("non-finite" in s for s in labels) == 2


# (W, C, R) -> (cs, table rows a block, slab columns, groups, rows/cluster)
@pytest.mark.parametrize("W,C,R,expect", [
    (512, 128, 256, (8, 64, 128, 1, 256)),          # the probe: 32 KB a block
    (100, 36, 300, (8, 13, 36, 2, 150)),
    (700, 8, 1000, (8, 88, 8, 4, 250)),
    (2000, 64, 4096, (8, 250, 64, 16, 256)),        # spans the cluster
    (4000, 256, 512, (8, 500, 64, 2, 256)),         # four column slabs
    (1817, 32, 256, (8, 228, 32, 1, 256)),
    (14_000, 8, 256, (8, 1750, 8, 1, 256)),
    (20_000, 1024, 256, (8, 2500, 16, 1, 256)),     # 64 slabs, one group
    (115_704, 4, 50, (8, 14_463, 4, 1, 50)),        # the largest table
    (3, 8, 10, (3, 1, 8, 1, 10)),                   # fewer rows than 8
])
def test_plan(W, C, R, expect):
    """K3/K4's launch plan: the largest portable cluster, the widest column
    slab (a multiple of 4 dividing C) whose rows fit a block's shared
    memory, and output-row groups of clusters."""
    p = gp.plan(W, C, R)
    assert p.args == expect
    assert p.smem == 4 * p.rows * p.slab + 4 * gp.CHUNK + 8 <= gp.SMEM_LIMIT
    assert C % p.slab == 0 and p.slab % 4 == 0
    assert 1 <= p.cs <= gp.CLUSTER_MAX and p.cs * p.rows >= W
    assert p.groups * p.rows_per_cluster >= R
    assert p.groups == 1 or p.groups * (C // p.slab) <= gp.MAX_CLUSTERS
    # no wider slab dividing C would fit
    wider = [s for s in range(p.slab + 4, C + 1, 4) if C % s == 0]
    assert all(4 * p.rows * s + 4 * gp.CHUNK + 8 > gp.SMEM_LIMIT
               for s in wider)


@pytest.mark.parametrize("W,C", [(512, 30), (115_705, 4),
                                 (gp.PRODUCTION_SHAPE[0], 32), (0, 8)])
def test_plan_refused(W, C):
    """Not a multiple of 4 wide, too many rows for a cluster of 8, or no
    rows: refused, naming gather_loop."""
    with pytest.raises(ValueError, match="use gather_loop"):
        gp.plan(W, C, 256)


def test_kernel_input_checks():
    """The wrapper's validation (device-independent) refuses what the
    kernels do not take."""
    tab, idx = gp.probe_inputs("cpu")
    gp._check(tab, idx)                                     # accepted
    with pytest.raises(TypeError, match="int32"):
        gp._check(tab, idx.long())
    with pytest.raises(TypeError, match="float32"):
        gp._check(tab.double(), idx)
    with pytest.raises(ValueError, match="need tab"):
        gp._check(tab, idx[None])
    with pytest.raises(ValueError, match="W >= 1"):
        gp._check(tab[:0], idx)
    with pytest.raises(ValueError, match="contiguous"):
        gp._check(tab.t().contiguous().t(), idx)


def test_entry_point_needs_a_gpu(capsys, monkeypatch):
    """The probe entry point measures the card; without one it fails and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gp.main([]) == 2
    assert capsys.readouterr().out == ""


def test_compare_probes_renames_the_parent(tmp_path):
    """utils/compare_probes: the other commit's source gets its own C++
    namespace (two libraries with equal kernel names cannot launch in one
    process), and its entry point's signature is read from the source."""
    from ceedpetscsolid_tpu_torch.csrc.build import CSRC
    from ceedpetscsolid_tpu_torch.utils import compare_probes as cp

    out, planned = cp.renamed_source(CSRC, tmp_path / "src")
    src = (out / "gather_probe.cu").read_text()
    assert planned and "namespace gp_parent {" in src
    assert "namespace gp {" not in src and "gp::" not in src.replace(
        "gp_parent::", "")
    old = tmp_path / "old"
    old.mkdir()
    (old / "gather_probe.cu").write_text(
        "namespace gp {\n}\nint f() { return gp::g(); }\n")
    out, planned = cp.renamed_source(old, tmp_path / "old_src")
    assert not planned
    assert (out / "gather_probe.cu").read_text() == (
        "namespace gp_parent {\n}\nint f() { return gp_parent::g(); }\n")
