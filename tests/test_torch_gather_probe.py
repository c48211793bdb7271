"""The row-gather probes (ops/gather_probe.py) on the CPU.

The JAX probe kernels of scripts/try_pallas_gather.py are closures inside
its main() that need TPU memory spaces, so they cannot be called here. The
oracle is the JAX op of each body, evaluated by JAX on the CPU:
jnp.take (k_take), jnp.take_along_axis (k_taa), lax.dynamic_slice per row
(k_loop's pl.ds) and the iota one-hot product (k_onehot), and for indices
in range the script's own reference, np.asarray(tab)[np.asarray(idx)] (its
line 41). The plain versions, and the wrappers on CPU tensors, must equal
it bitwise, NaN rows included. The kernels themselves are held bitwise
against the plain versions on the card by tests/test_torch_gpu.py.
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
    assert len(labels) == len(gp.CHECK_SHAPES) + 2
    assert sum("out of range" in s for s in labels) == 2


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
