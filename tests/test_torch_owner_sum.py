"""The owner-sum's CSR table (ops/restriction.csr_table) and its CUDA
kernel (csrc/owner_sum.cu).

Imports no JAX: the port's plain CPU `Restriction.scatter_add` is the
reference. The CPU tests hold the table to the transpose of the
connectivity, and its sum in the kernel's order (csr_sum) to the plain
scatter_add; the tests marked `gpu` hold the kernel bit for bit to
csr_sum. On the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_owner_sum.py -q
"""

import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh
from ceedpetscsolid_tpu_torch.ops.restriction import Restriction, csr_table
from ceedpetscsolid_tpu_torch.parallel.partition import partition_space
from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem
from ceedpetscsolid_tpu_torch.utils import timing


def _space_case(mesh, degree):
    s = build_fespace(mesh, degree)
    return s.conn, s.num_nodes, s.entity_node_ranges()


def _rank_case(batch):
    """Rank 1's interior or boundary batch of the four-rank partition of
    the 4x4x8 p2 box, as parallel/dist.RankArrays builds its restrictions
    (no node ranges)."""
    s = build_fespace(box_mesh((4, 4, 8)), 2)
    part = partition_space(s.conn, s.num_nodes, 4)
    conn = part.conn_local[1][part.elem_valid[1]]
    k = part.n_elem_int
    assert 0 < k < len(conn)
    if batch == "int":
        return conn[:k], part.n_owned_max, None
    return conn[k:], part.n_local, None


CASES = {
    "box3-p1": lambda: _space_case(box_mesh((3, 3, 3)), 1),
    "box3-p2": lambda: _space_case(box_mesh((3, 3, 3)), 2),
    "box3-p4": lambda: _space_case(box_mesh((3, 3, 3)), 4),
    "scrambled3-p2": lambda: _space_case(scrambled_box_mesh((3, 3, 3),
                                                            seed=3), 2),
    "rank-int": lambda: _rank_case("int"),
    "rank-bnd": lambda: _rank_case("bnd"),
}
NCOMP = [1, 3, 8]


def csr_sum(ve: np.ndarray, offsets, positions) -> np.ndarray:
    """The owner-sum in the kernel's order: the k-th position of a node
    (ascending, from 0) added into running sum k mod 4, each started at
    +0.0, and the node's value (s0 + s1) + (s2 + s3) (IEEE additions in
    ve's dtype, as the kernel makes them)."""
    flat = ve.reshape(ve.shape[0], -1)
    counts = np.diff(offsets)
    acc = np.zeros((4, ve.shape[0], counts.size), ve.dtype)
    for k in range(counts.max(initial=0)):
        rows = np.nonzero(counts > k)[0]
        acc[k % 4][:, rows] += flat[:, positions[offsets[rows] + k]]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _ve(conn, ncomp, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ncomp, *conn.shape)).astype(dtype)


@pytest.mark.parametrize("case", CASES)
def test_csr_table_is_the_transpose(case):
    """Every E-position appears once; each node's positions ascend and
    reference that node; the offsets are the cumulative bincount."""
    conn, n, _ = CASES[case]()
    offsets, positions = csr_table(conn, n)
    assert offsets.dtype == positions.dtype == np.int32
    np.testing.assert_array_equal(np.sort(positions), np.arange(conn.size))
    np.testing.assert_array_equal(
        offsets, np.concatenate([[0], np.cumsum(np.bincount(
            conn.ravel(), minlength=n))]))
    node = np.repeat(np.arange(n), np.diff(offsets))
    np.testing.assert_array_equal(conn.ravel()[positions], node)
    same = node[1:] == node[:-1]
    assert (positions[1:][same] > positions[:-1][same]).all()


@pytest.mark.parametrize("ncomp", NCOMP)
@pytest.mark.parametrize("case", CASES)
def test_csr_sum_matches_scatter_add(case, ncomp):
    """The sum in the kernel's order equals the plain scatter_add to float64
    rounding: at most 8 ulps of each node's sum of magnitudes."""
    conn, n, ranges = CASES[case]()
    offsets, positions = csr_table(conn, n)
    ve = _ve(conn, ncomp, np.float64, seed=ncomp)
    got = csr_sum(ve, offsets, positions)
    want = Restriction(conn, n, ranges, device="cpu").scatter_add(
        torch.as_tensor(ve)).numpy()
    bound = 8 * np.finfo(np.float64).eps * csr_sum(np.abs(ve), offsets,
                                                  positions)
    assert (np.abs(got - want) <= bound).all()


def test_owner_sum_counters_on_cpu():
    """Each scatter_add counts one call in the open request; the CPU
    launches no kernel."""
    conn, n, ranges = CASES["box3-p2"]()
    r = Restriction(conn, n, ranges, device="cpu")
    ve = torch.as_tensor(_ve(conn, 3, np.float64))
    with timing.request("owner_sum_test"):
        r.scatter_add(ve)
        r.scatter_add(ve[:1])
    counts = timing.records()[-1]["counts"]
    assert counts == {"restr.owner_sum_calls": 2}


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on a GPU")
    return torch.device("cuda")


GPU_CASES = {**CASES,
             "box28-p4": lambda: _space_case(box_mesh((28, 28, 28)), 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", GPU_CASES)
def test_kernel_is_the_csr_sum(cuda, case, dtype):
    """The kernel's owner-sum equals the CPU's csr_sum bit for
    bit, for 1, 3 and 8 components."""
    conn, n, ranges = GPU_CASES[case]()
    offsets, positions = csr_table(conn, n)
    r = Restriction(conn, n, ranges, device=cuda)
    for ncomp in NCOMP:
        ve = _ve(conn, ncomp, dtype, seed=ncomp)
        got = r.scatter_add(torch.as_tensor(ve, device=cuda)).cpu().numpy()
        want = csr_sum(ve, offsets, positions)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.gpu
def test_kernel_is_deterministic(cuda):
    """Two calls on one input agree bit for bit (28^3 p4, float32, a
    vector field)."""
    conn, n, ranges = GPU_CASES["box28-p4"]()
    r = Restriction(conn, n, ranges, device=cuda)
    ve = torch.as_tensor(_ve(conn, 3, np.float32), device=cuda)
    a, b = r.scatter_add(ve), r.scatter_add(ve)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_jacobi_cg_engages_the_kernel(cuda):
    """On a Jacobi CG solve of the 8^3 p4 box every owner-sum of the
    request launches the kernel."""
    prob = ElasticityProblem(Config(
        problem="hyperFS", degree=4, test_mode=True, box_faces=(8, 8, 8),
        multigrid="none", num_increments=1, device=cuda, ksp_rtol=1e-6))
    prob.solve()
    counts = timing.records()[-1]["counts"]
    assert counts["restr.owner_sum_calls"] > counts["cg.iterations"] > 0
    assert counts["restr.owner_sum_kernel"] == counts["restr.owner_sum_calls"]
