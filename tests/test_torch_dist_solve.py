"""Solves of the port's DistributedProblem on four gloo rank processes
(float64, CPU) against the JAX package's serial solve of the same problem,
as tests/test_distributed.py holds the JAX package's distributed driver to
its serial one: linElas with Jacobi (one and four ranks) and with p-MG +
the replicated AMG coarse solve, hyperFS with p-MG + AMG in two
increments; and the eigenvalue probe vector against the JAX package's
hash, bit for bit. The distributed p-MG integrates every level at the
fine quadrature, as the JAX package's distributed driver does; its KSP
count may exceed the serial's by 2 (tests/test_distributed.py:67).

Where only the solution is compared (hyperFS), the JAX serial reference
solves the same problem with Jacobi CG: its solution is the p-MG serial
solve's to 1.4e-14 (|u| ~ 5e-7), and it compiles in ~10 s where the
p-MG serial solve takes ~55 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import native
from ceedpetscsolid_tpu_torch.parallel import launch, tasks
from ceedpetscsolid_tpu_torch.parallel.mg import probe_vector

BOX = dict(nu=0.3, E=1.0, test_mode=True, box_faces=(3, 3, 3))
LIN_JACOBI = dict(BOX, problem="linElas", degree=2, multigrid="none")
LIN_PMG = dict(BOX, problem="linElas", degree=3, multigrid="logarithmic")
HYPERFS_PMG = dict(BOX, problem="hyperFS", degree=2,
                   multigrid="logarithmic", num_increments=2)


@pytest.fixture(scope="module", autouse=True)
def _amg_library():
    native.build()


def jax_serial(cfg):
    info = JProblem(JConfig(**cfg)).solve()
    return np.asarray(info.u), info


def dist_solve(tmp_path, cfg, world=4):
    out = launch.run(tasks.problem_task, world, "gloo", "cpu", tmp_path,
                     args=(cfg, [("solve", {})]))
    return out["solve"]["u"], out["solve"]["info"], out


@pytest.fixture(scope="module")
def lin_jacobi_ref():
    return jax_serial(LIN_JACOBI)


@pytest.mark.parametrize("world", [1, 4])
def test_linelas_jacobi_matches_jax_serial(tmp_path, lin_jacobi_ref, world):
    u_ref, _ = lin_jacobi_ref
    u, info, out = dist_solve(tmp_path, LIN_JACOBI, world)
    assert info["converged"]
    assert np.abs(u - u_ref).max() < 1e-12
    assert not out["use_mg"]


def test_linelas_pmg_amg_matches_jax_serial(tmp_path):
    u_ref, ref = jax_serial(LIN_PMG)
    u, info, out = dist_solve(tmp_path, LIN_PMG)
    assert out["use_mg"]
    assert info["ksp_iters"] <= ref.ksp_iters + 2
    assert np.abs(u - u_ref).max() < 1e-12


def test_hyperfs_pmg_amg_matches_jax_serial(tmp_path):
    """The AMG is refreshed from the ranks' stashes every Newton step."""
    u_ref, _ = jax_serial(dict(HYPERFS_PMG, multigrid="none"))
    u, info, out = dist_solve(tmp_path, HYPERFS_PMG)
    assert out["use_mg"] and info["converged"]
    assert info["rnorm"] < 1e-10
    assert np.abs(u - u_ref).max() < 1e-10


@pytest.mark.parametrize("shape", [(3, 1), (3, 123), (3, 40_000)])
def test_probe_vector_is_jax_hash(shape):
    """mg.probe_vector against ceedpetscsolid_tpu/parallel/mg.py:158-161
    (the shard-local uint32 hash), float64 and float32, bit for bit."""
    n = int(np.prod(shape))
    idx = jax.lax.broadcasted_iota(jnp.uint32, (n, 1), 0).reshape(shape)
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        ref = ((idx * jnp.uint32(2654435761) % jnp.uint32(65536)).astype(jdt)
               / 65536.0) - 0.5
        got = probe_vector(shape, tdt, "cpu").numpy()
        assert got.dtype == np.asarray(ref).dtype
        assert np.array_equal(got, np.asarray(ref))
