"""The port's distributed driver (ceedpetscsolid_tpu_torch/parallel/) on the
CPU: its exchange primitives against the global numpy result, its residual
against the JAX package's serial one, and one Newton step against the JAX
package's own DistributedProblem (float64).

Each multi-rank case spawns gloo rank processes (parallel/launch.py, a
FileStore under tmp_path); the rank functions (parallel/tasks.py) raise if
a rank has imported JAX. The JAX oracle runs in the pytest process."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import interop, native
from ceedpetscsolid_tpu_torch.parallel import launch, tasks
from ceedpetscsolid_tpu_torch.parallel.dist import Comm, check_backend
from ceedpetscsolid_tpu_torch.parallel.partition import (
    partition_space,
    scatter_global_to_owned,
)

REPO = Path(__file__).resolve().parents[1]
PORT_PARALLEL = REPO / "ceedpetscsolid_tpu_torch" / "parallel"
SPACES = [("box", (3, 3, 3), 2), ("scrambled", (4, 4, 4), 2, 4)]
HYPERFS = dict(problem="hyperFS", degree=2, nu=0.3, E=1.0, test_mode=True,
               box_faces=(3, 3, 3), multigrid="none")
LINELAS = dict(problem="linElas", degree=2, nu=0.3, E=1.0, test_mode=True,
               box_faces=(3, 3, 3), multigrid="none")


@pytest.fixture(scope="module", autouse=True)
def _amg_library():
    """Build the native AMG library once, before any rank needs it."""
    native.build()


def test_partition_is_a_copy():
    """parallel/partition.py is the JAX package's, line for line below the
    first line of its docstring."""
    j = (REPO / "ceedpetscsolid_tpu/parallel/partition.py").read_text()
    t = (PORT_PARALLEL / "partition.py").read_text()
    assert t.split("\n")[1:] == j.split("\n")[1:]


@pytest.mark.parametrize(
    "path", sorted(PORT_PARALLEL.glob("*.py"))
    + [PORT_PARALLEL.parent / "utils" / "weak_scaling.py"],
    ids=lambda p: p.name)
def test_parallel_imports_neither_jax_nor_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "ceedpetscsolid_tpu"), \
                f"{path.name} imports {name}"


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("spec", SPACES, ids=["box3", "scrambled4"])
def test_exchange_matches_global(tmp_path, spec, world):
    """g2l fills every touched local slot with the global value; l2g_add
    sums the (rank + 1) g contributions of every rank holding a node;
    ddot and dnorm are the global ones (1e-14)."""
    out = launch.run(tasks.exchange_task, world, "gloo", "cpu", tmp_path,
                     args=(spec, 0))
    space = tasks.space_of(spec)
    part = partition_space(space.conn, space.num_nodes, world)
    u, g, a, b = tasks.exchange_fields(space.num_nodes, 0)
    weight = np.zeros(space.num_nodes)
    for r in range(world):
        valid = part.elem_valid[r]
        glob = np.full(part.n_local, -1)
        glob[part.conn_local[r][valid].ravel()] = \
            space.conn[part.elem_gid[r][valid]].ravel()
        seen = glob >= 0
        assert np.abs(out[r]["local"][:, seen] - u[:, glob[seen]]).max() \
            <= 1e-14 * np.abs(u).max()
        weight[glob[seen]] += r + 1
    want = scatter_global_to_owned(part, g * weight)
    for r in range(world):
        assert np.abs(out[r]["l2g"] - want[r]).max() <= 1e-14 * np.abs(
            want).max()
    assert out[0]["dot"] == pytest.approx(float((a * b).sum()), rel=1e-14,
                                          abs=1e-14 * np.abs(a * b).sum())
    assert out[0]["norm"] == pytest.approx(float(np.linalg.norm(a)),
                                           rel=1e-14)


@pytest.mark.parametrize("world", [1, 4])
def test_residual_apply_matches_jax_serial(tmp_path, world):
    """hyperFS degree 2 on 3^3 at a seeded small u: the distributed
    residual (fused apply on each rank's interior and boundary batches,
    halo exchange, owner-sum) to 1e-12 of max |G| of JAX's serial
    _nonlinear_residual."""
    jp = JProblem(JConfig(**HYPERFS))
    N = jp.fine_space.num_nodes
    u = np.random.default_rng(5).standard_normal((3, N)) * 1e-3
    G, _ = jp._nonlinear_residual(jnp.asarray(u), jp.bc_values(1.0), jp.F)
    G = np.asarray(G)
    out = launch.run(tasks.problem_task, world, "gloo", "cpu", tmp_path,
                     args=(HYPERFS,
                           [("residual", (u, 1.0))]))
    assert np.abs(out["residual"] - G).max() <= 1e-12 * np.abs(G).max()


def test_newton_step_matches_jax_distributed(tmp_path):
    """One Newton step of linElas degree 2 on 3^3 with Jacobi CG, from the
    same owned u0 (JAX's to_owned, carried over by interop.owned_from_jax):
    the port on four gloo ranks against JAX's
    DistributedProblem(ndev=4, use_slab=False). rnorm_in and rnorm to
    1e-10 relative, equal CG iterations, u1 to 1e-10; owned_to_jax
    inverts owned_from_jax."""
    from ceedpetscsolid_tpu.parallel.driver import DistributedProblem

    jp = JProblem(JConfig(**LINELAS))
    dp = DistributedProblem(jp, ndev=4, use_slab=False)
    N = jp.fine_space.num_nodes
    u0 = dp.to_owned(np.random.default_rng(2).standard_normal((3, N)) * 1e-3)
    u1, rnorm_in, rnorm, iters, _, _ = dp.newton_step(u0, 1.0)
    blocks = np.asarray(u0)
    assert np.array_equal(interop.owned_to_jax(
        [interop.owned_from_jax(blocks, r, device="cpu")
         for r in range(4)]), blocks)
    out = launch.run(tasks.problem_task, 4, "gloo", "cpu", tmp_path,
                     args=(LINELAS, [("step", (blocks, 1.0))]))
    got = out["step"]
    assert got["rnorm_in"] == pytest.approx(float(rnorm_in), rel=1e-10)
    assert got["rnorm"] == pytest.approx(float(rnorm), rel=1e-10)
    assert got["iters"] == int(iters)
    ref = dp.to_global(u1)
    assert np.abs(got["u1"] - ref).max() <= 1e-10 * np.abs(ref).max()


def test_backend_rule(tmp_path):
    """NCCL with more ranks than CUDA devices raises before any rank
    starts, and so does a backend other than nccl and gloo; the slab path
    raises by name."""
    from ceedpetscsolid_tpu_torch.parallel.driver import DistributedProblem

    with pytest.raises(RuntimeError, match="NCCL runs one rank a card"):
        check_backend("nccl", 2, "cuda")
    with pytest.raises(RuntimeError, match="NCCL runs one rank a card"):
        launch.run(tasks.exchange_task, 2, "nccl", "cuda", tmp_path,
                   args=(SPACES[0],))
    with pytest.raises(ValueError, match="unknown backend"):
        launch.run(tasks.exchange_task, 2, "mpi", "cpu", tmp_path,
                   args=(SPACES[0],))
    with pytest.raises(ValueError, match="NCCL exchanges CUDA tensors"):
        check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="SpectralLattice"):
        DistributedProblem(None, use_slab=True)


def test_launch_and_comm_take_no_default_device(tmp_path):
    """launch.run has no default backend, device or store directory, and
    Comm no default device: a caller that forgets the device gets a
    TypeError, not ranks on the CPU."""
    with pytest.raises(TypeError):
        launch.run(tasks.exchange_task, 2, "gloo", args=(SPACES[0],))
    with pytest.raises(TypeError):
        launch.run(tasks.exchange_task, 2, args=(SPACES[0],))
    with pytest.raises(TypeError):
        Comm(None)


def test_a_failing_rank_stops_the_run(tmp_path):
    """A rank that raises makes run raise with that rank's traceback after
    every rank stopped, and leaves neither store nor result file."""
    with pytest.raises(Exception, match="unknown job 'nope'"):
        launch.run(tasks.problem_task, 2, "gloo", "cpu", tmp_path,
                   args=(LINELAS, [("nope", None)]))
    assert list(tmp_path.iterdir()) == []
