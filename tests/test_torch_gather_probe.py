"""The row-gather probes (ops/gather_probe.py) on the CPU.

The JAX probe kernels of scripts/try_pallas_gather.py are closures inside
its main() that need TPU memory spaces, so they cannot be called here; the
script's own reference, np.asarray(tab)[np.asarray(idx)] (its line 41), is
the oracle. The plain versions must equal it bitwise, on inputs made with
numpy at the script's shapes. The kernels themselves are held bitwise
against the plain versions on the card by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu_torch.ops import gather_probe as gp


@pytest.mark.parametrize("shape", [gp.PROBE_SHAPE, (100, 300, 36),
                                   (20_000, 4_000, 32)])
@pytest.mark.parametrize("name", list(gp.KINDS))
def test_plain_versions_equal_script_reference(name, shape):
    """Every plain version (and the wrapper on CPU tensors) is bitwise
    np.asarray(tab)[np.asarray(idx)]; W, R, C = shape."""
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


def test_probe_inputs_are_the_script_shapes():
    tab, idx = gp.probe_inputs("cpu")
    assert tab.shape == (512, 128) and tab.dtype == torch.float32
    assert idx.shape == (256,) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 512
    W, R, C = gp.PRODUCTION_SHAPE
    assert (W, R, C) == (200_000, 44_928 * 26, 32)


@pytest.mark.parametrize("W,C,slab", [(512, 128, 32), (100, 36, 12),
                                      (1816, 32, 32), (1817, 32, 16),
                                      (14_000, 8, 4)])
def test_slab_columns(W, C, slab):
    """The staged column slab: a multiple of 4 dividing C, at most 32
    columns, whose W rows fit in 227 KB of shared memory."""
    s = gp.slab_columns(W, C)
    assert s == slab
    assert C % s == 0 and s % 4 == 0 and 4 * W * s <= gp.SMEM_LIMIT


@pytest.mark.parametrize("W,C", [(20_000, 4), (512, 30)])
def test_slab_refused(W, C):
    with pytest.raises(ValueError, match="no column slab"):
        gp.slab_columns(W, C)


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
    with pytest.raises(ValueError, match="contiguous"):
        gp._check(tab.t().contiguous().t(), idx)


def test_entry_point_needs_a_gpu(capsys, monkeypatch):
    """The probe entry point measures the card; without one it fails and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gp.main([]) == 2
    assert capsys.readouterr().out == ""
