"""The port's CUDA kernels on the card (marked `gpu`; skipped without one).

Imports no JAX, so it runs on a GPU machine that has none: the port's CPU
float64 path, itself held against the JAX package by the other
tests/test_torch_*.py files, is the reference here. On the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

(--noconftest: tests/conftest.py configures JAX, which is absent there.)
"""

import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh
from ceedpetscsolid_tpu_torch.models import Physics
from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
from ceedpetscsolid_tpu_torch.ops import gather_probe as gp
from ceedpetscsolid_tpu_torch.ops.basis import Basis3D
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory
from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem

pytestmark = pytest.mark.gpu
PHYS = Physics(nu=0.3, E=1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on a GPU")
    return torch.device("cuda")


def _case(kind, degree, device, seed=0, qextra=0, q1d=None):
    mesh = box_mesh((3, 3, 3)) if kind == "box" else scrambled_box_mesh(
        (3, 3, 3), seed=3)
    f = OperatorFactory(build_fespace(mesh, degree), qextra=qextra,
                        dtype=torch.float64, device=device, q1d=q1d)
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes)) * 1e-3,
                            device=device) for _ in range(2))
    return f, f.compute_qdata(), u, v


@pytest.mark.parametrize("kind", ["box", "scrambled"])
@pytest.mark.parametrize("degree,qextra", [(1, 0), (2, 0), (3, 0), (4, 0),
                                           (1, 3), (2, 2), (4, 1)])
def test_kernel_matches_plain(cuda, kind, degree, qextra):
    """float64 kernel vs float64 plain to 1e-12 of max|ref| (only rounding
    order differs); float32 kernel vs float64 plain to rtol 2e-5 plus
    1e-6 max|ref| (float32 rounding alone reaches ~6e-7 max|ref|). P = Q
    from 2 (the p = 1 level of p-MG) to 5, and the P < Q instances (2, 5),
    (3, 5), (5, 6): a coarse p-MG level at the fine level's rule, or a
    -qextra run."""
    f, q, u, v = _case(kind, degree, cuda, seed=degree, qextra=qextra)
    conn, b = f.restr.conn, f.basis
    ve0, st0 = fa.residual_plain(u, conn, q, b, PHYS)
    jv0 = fa.jacobian_plain(v, conn, q, st0, b, PHYS)
    ve, st = fa.residual(u, conn, q, b, PHYS)
    jv = fa.jacobian(v, conn, q, st0, b, PHYS)
    for got, ref in ((ve, ve0), (st, st0), (jv, jv0)):
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-12
    f32 = torch.float32
    b32 = Basis3D.create(b.P, b.Q, "gauss", f32, device=cuda)
    ve, st = fa.residual(u.to(f32), conn, q.to(f32), b32, PHYS)
    jv = fa.jacobian(v.to(f32), conn, q.to(f32), st0.to(f32), b32, PHYS)
    for got, ref in ((ve, ve0), (st, st0), (jv, jv0)):
        err = (got.double() - ref).abs()
        assert bool((err <= 2e-5 * ref.abs() + 1e-6 * ref.abs().max()).all())


def _check_physics(f, q, u, v, physics, device):
    """Kernel vs plain for one physics at the tolerances of
    test_kernel_matches_plain; a physics without a stash has none."""
    conn, b = f.restr.conn, f.basis
    ve0, st0 = fa.residual_plain(u, conn, q, b, PHYS, physics)
    jv0 = fa.jacobian_plain(v, conn, q, st0, b, PHYS, physics)
    ve, st = fa.residual(u, conn, q, b, PHYS, physics)
    jv = fa.jacobian(v, conn, q, st0, b, PHYS, physics)
    assert (st is None) == (st0 is None) == (physics == "linElas")
    pairs = [(ve, ve0), (jv, jv0)] + ([(st, st0)] if st0 is not None else [])
    for got, ref in pairs:
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-12
    f32 = torch.float32
    b32 = Basis3D.create(b.P, b.Q, "gauss", f32, device=device)
    st32 = None if st0 is None else st0.to(f32)
    ve, st = fa.residual(u.to(f32), conn, q.to(f32), b32, PHYS, physics)
    jv = fa.jacobian(v.to(f32), conn, q.to(f32), st32, b32, PHYS, physics)
    pairs = [(ve, ve0), (jv, jv0)] + ([(st, st0)] if st0 is not None else [])
    for got, ref in pairs:
        err = (got.double() - ref).abs()
        assert bool((err <= 2e-5 * ref.abs() + 1e-6 * ref.abs().max()).all())


@pytest.mark.parametrize("physics", ["linElas", "hyperSS", "hyperFSIncomp"])
@pytest.mark.parametrize("kind", ["box", "scrambled"])
@pytest.mark.parametrize("degree,qextra", [(1, 0), (2, 0), (3, 0), (4, 0),
                                           (2, 2), (4, 1)])
def test_physics_kernels_match_plain(cuda, physics, kind, degree, qextra):
    """The other full-quadrature physics (linElas without a stash, hyperSS,
    hyperFSIncomp's mu part) at P = Q and P < Q, at the tolerances above."""
    f, q, u, v = _case(kind, degree, cuda, seed=degree, qextra=qextra)
    _check_physics(f, q, u, v, physics, cuda)


@pytest.mark.parametrize("kind", ["box", "scrambled"])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_pressure_kernels_match_plain(cuda, kind, degree):
    """hyperFSIncomp's pressure term at one point per element: the (P, 1)
    instances, P = 2..6."""
    f, q, u, v = _case(kind, degree, cuda, seed=degree, q1d=1)
    assert (f.basis.P, f.basis.Q) == (degree + 1, 1)
    _check_physics(f, q, u, v, "hyperFSIncomp-pressure", cuda)


def _misaligned(t):
    """A copy of `t` one word past a 16-byte boundary (contiguous)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("physics", ["hyperFS", "linElas", "hyperSS",
                                     "hyperFSIncomp-pressure"])
@pytest.mark.parametrize("faces,degree,dtype,shift,paths", [
    # float32 at (P, Q) = (5, 5), one element a warp tile, and (5, 1): one
    # element (under the pressure term's block tile); 27, whose planes are
    # no multiple of 16 bytes; 24, whose are; 24 through misaligned streams
    ((1, 1, 1), 4, torch.float32, False, ("async", "async")),
    ((3, 3, 3), 4, torch.float32, False, ("async", "async")),
    ((4, 3, 2), 4, torch.float32, False, ("bulk", "bulk")),
    ((4, 3, 2), 4, torch.float32, True, ("async", "async")),
    # ragged last warp tiles: (4, 4) two elements a tile, 27 elements;
    # (3, 3) three a tile, 4 elements; (2, 2) eight a tile, 27 and 1
    ((3, 3, 3), 3, torch.float32, False, ("bulk", "async")),
    ((2, 2, 1), 2, torch.float32, False, ("bulk", "bulk")),
    ((3, 3, 3), 1, torch.float32, False, ("bulk", "async")),
    ((1, 1, 1), 1, torch.float32, False, ("bulk", "async")),
    # float64: 27 elements; two; P = Q = 6 (under the block tile)
    ((3, 3, 3), 4, torch.float64, False, ("async", "async")),
    ((2, 1, 1), 4, torch.float64, False, ("bulk", "bulk")),
    ((3, 3, 1), 5, torch.float64, False, ("bulk", "async")),
])
def test_tile_edges_match_plain(cuda, physics, faces, degree, dtype, shift,
                                paths):
    """The tiled kernels at their edges, against the float64 plain version
    at the tolerances of test_kernel_matches_plain: a tile larger than the
    mesh, ragged last tiles, both copy paths (TMA bulk copies, and cp.async
    for streams whose planes are no multiple of 16 bytes or whose base is
    misaligned), float64 at P = Q = 6. The kernel's own plan takes the path
    copy_path names, and the launch is counted under it; a warp tile holds
    max(1, 32 // Q^2) elements."""
    q1d = 1 if physics.endswith("pressure") else None
    path = paths[1] if q1d else paths[0]
    f = OperatorFactory(build_fespace(box_mesh(faces), degree),
                        dtype=torch.float64, device=cuda, q1d=q1d)
    rng = np.random.default_rng(degree)
    u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes))
                            * 1e-3, device=cuda) for _ in range(2))
    q, conn, b = f.compute_qdata(), f.restr.conn, f.basis
    ve0, st0 = fa.residual_plain(u, conn, q, b, PHYS, physics)
    jv0 = fa.jacobian_plain(v, conn, q, st0, b, PHYS, physics)
    bt = Basis3D.create(b.P, b.Q, "gauss", dtype, device=cuda)
    qt = q.to(dtype)
    st_in = None if st0 is None else st0.to(dtype)
    if shift:
        qt = _misaligned(qt)
        st_in = None if st_in is None else _misaligned(st_in)
    assert fa.copy_path(qt, st_in) == path
    assert fa.plan(True, qt, bt, st_in, physics).path == path
    plan = fa.plan(False, qt, bt, None, physics)
    assert plan.path == path
    if q1d or (dtype == torch.float64 and b.P == 6):
        assert plan.threads > 32            # a block tile
    else:
        assert (plan.elems, plan.threads) == (max(1, 32 // b.Q ** 2), 32)
    assert plan.tiles == -(-conn.shape[0] // plan.elems)
    fa.COUNTS.reset()
    ve, st = fa.residual(u.to(dtype), conn, qt, bt, PHYS, physics)
    jv = fa.jacobian(v.to(dtype), conn, qt, st_in, bt, PHYS, physics)
    torch.cuda.synchronize()
    assert fa.COUNTS.by_path == {("residual", path): 1, ("jacobian", path): 1}
    pairs = [(ve, ve0), (jv, jv0)] + ([(st, st0)] if st0 is not None else [])
    for got, ref in pairs:
        err = (got.double() - ref).abs()
        if dtype == torch.float64:
            assert float(err.max() / ref.abs().max()) <= 1e-12
        else:
            assert bool((err <= 2e-5 * ref.abs()
                         + 1e-6 * ref.abs().max()).all())


def test_launch_counts_and_refusals(cuda):
    f, q, u, v = _case("box", 2, cuda)
    conn, b = f.restr.conn, f.basis
    fa.COUNTS.reset()
    _, st = fa.residual(u, conn, q, b, PHYS)
    fa.jacobian(v, conn, q, st, b, PHYS)
    fa.jacobian(v, conn, q, st, b, PHYS)
    torch.cuda.synchronize()
    assert (fa.COUNTS.residual_launches, fa.COUNTS.jacobian_launches) == (1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.jacobian(v, conn, q, st.transpose(1, 2).contiguous().transpose(1, 2),
                    b, PHYS)
    with pytest.raises(ValueError, match="on cpu"):
        fa.residual(u, conn, q.cpu(), b, PHYS)
    assert fa.COUNTS.by_pq == {("residual", 3, 3): 1, ("jacobian", 3, 3): 2}
    assert fa.COUNTS.by_physics == {("hyperFS", "residual", 3, 3): 1,
                                    ("hyperFS", "jacobian", 3, 3): 2}
    assert fa.COUNTS.by_shape == {("hyperFS", "residual", 3, 3, 27): 1,
                                  ("hyperFS", "jacobian", 3, 3, 27): 2}
    # 27 elements of 27 float64 points: no plane a multiple of 16 bytes
    assert fa.COUNTS.by_path == {("residual", "async"): 1,
                                 ("jacobian", "async"): 2}
    # linElas takes no stash and refuses one
    with pytest.raises(ValueError, match="no stash"):
        fa.jacobian(v, conn, q, st, b, PHYS, "linElas")
    assert (fa.COUNTS.residual_launches, fa.COUNTS.jacobian_launches) == (1, 2)
    # (P, Q) = (3, 7), degree 2 at -qextra 4, and the pressure term at
    # (3, 3) have no template instance: the generic tile runs them, counted
    # under its own path
    f2 = OperatorFactory(f.space, qextra=4, dtype=torch.float64, device=cuda)
    fa.residual(u, f2.restr.conn, f2.compute_qdata(), f2.basis, PHYS)
    fa.residual(u, conn, q, b, PHYS, "hyperFSIncomp-pressure")
    torch.cuda.synchronize()
    assert fa.COUNTS.by_path[("residual", "generic")] == 2
    assert fa.COUNTS.by_physics[("hyperFSIncomp-pressure", "residual", 3,
                                 3)] == 1
    Config(problem="hyperFS", degree=2, multigrid="none", qextra=4,
           device=cuda)


# phase 3d of chip_smoke.py: (faces, degree, qextra or None, q1d, physics)
GENERIC_CASES = [
    *(((4, 4, 4), P - 1, kind, Q, "hyperFSIncomp-pressure")
      for P in (2, 3, 4, 5) for Q in (2, 3) for kind in ("box", "scrambled")),
    *(((3, 3, 3), P - 1, "box", Q, physics)
      for P, Q in ((7, 7), (8, 8), (6, 7), (2, 7))
      for physics in ("hyperFS", "linElas")),
    ((1, 1, 1), 9, "box", 10, "hyperSS"),
    ((1, 1, 1), 9, "box", 10, "hyperFSIncomp"),
    # one element; tiles of two elements with a ragged last one (1,331 //
    # (4 x 132) warp tiles, 343 // 132 block tiles)
    ((1, 1, 1), 4, "box", 2, "hyperFSIncomp-pressure"),
    ((1, 1, 1), 6, "box", 7, "hyperFS"),
    ((11, 11, 11), 4, "box", 2, "hyperFSIncomp-pressure"),
    ((11, 11, 11), 2, "box", 2, "hyperFSIncomp-pressure"),
    ((11, 11, 11), 6, "box", 1, "hyperFSIncomp-pressure"),
    ((7, 7, 7), 2, "box", 4, "hyperFSIncomp-pressure"),
]


@pytest.mark.parametrize("faces,degree,kind,Q,physics", GENERIC_CASES)
def test_generic_matches_plain(cuda, faces, degree, kind, Q, physics):
    """The generic tile (every (physics, P, Q) without a template
    instance) against the plain version at the tolerances of
    test_kernel_matches_plain: the pressure term at Q = 2, 3 (P > Q and
    P <= Q) and 4, hyperFS and linElas at Q = 7, 8, float64 and float32 at
    (10, 10) (the shared-memory body); meshes with fewer elements than the
    card has SMs, one element, and tiles of two with a ragged last one.
    Its plan, in both modes, is generic_plan's on the card's SM count, and
    its launches are counted under the plan's path."""
    mesh = box_mesh(faces) if kind == "box" else scrambled_box_mesh(faces, 4)
    f = OperatorFactory(build_fespace(mesh, degree), dtype=torch.float64,
                        device=cuda, q1d=Q)
    P = f.basis.P
    assert fa.is_generic(physics, P, Q)
    rng = np.random.default_rng(degree)
    u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes))
                            * 3e-3 / faces[0], device=cuda) for _ in range(2))
    q = f.compute_qdata()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pw = fa.pointwise(physics)
    for dtype in (torch.float64, torch.float32):
        qd = q.to(dtype)
        st = torch.zeros((9, f.nelem, f.Q3), dtype=dtype, device=cuda)
        for jac in (False, True):
            p = fa.plan(jac, qd, f.basis, st if jac else None, physics)
            g = fa.generic_plan(P, Q, dtype, f.nelem, sms,
                                19 if jac and pw.stash else 10)
            assert (p.path, p.body, p.elems, p.threads, p.smem, p.tiles) \
                == (g.path, g.body, g.elems, g.threads, g.smem, g.tiles)
            assert (p.copy is None) == (g.path != "generic")
    path = fa.generic_plan(P, Q, torch.float64, f.nelem, sms).path
    fa.COUNTS.reset()
    _check_physics(f, q, u, v, physics, cuda)
    torch.cuda.synchronize()
    assert fa.COUNTS.by_path == {("residual", path): 2,
                                 ("jacobian", path): 2}


def test_factory_defaults_to_cuda_in_float32(cuda):
    """OperatorFactory without a device or a dtype builds on CUDA in
    float32 (device.default_dtype), as ElasticityProblem does there."""
    f = OperatorFactory(build_fespace(box_mesh((2, 2, 2)), 2))
    assert f.device.type == "cuda"
    assert f.dtype == torch.float32
    assert f.basis.B.dtype == torch.float32
    assert f.compute_qdata().dtype == torch.float32


def test_generic_configurations_construct(cuda):
    """On CUDA, Config takes hyperFSIncomp with -qextra 2 (the pressure term
    at (P, 3)) and degree 7 ((8, 8)): the generic tile runs them."""
    Config(problem="hyperFSIncomp", qextra=2, device=cuda)
    Config(degree=7, device=cuda)
    Config(problem="hyperFS", degree=10, device=cuda, dtype=torch.float64)


# the shapes on either side of the block limit: (physics, box faces,
# degree, Q, dtype, body). The cluster body at one CTA an element's
# largest shapes, (11, 11) float64 and (14, 14) float32, and above them,
# where one element needs two CTAs ((12, 12) float64, (15, 15) float32,
# the pressure term's (21, 2) float64: the gmem body's shapes before the
# cluster body), one element each and 343 elements; the gmem body where
# no cluster of 8 CTAs holds an element, (23, 23) float64 and (29, 29)
# float32, and 343 elements on a persistent grid of 264 blocks (two an
# SM), whose first 79 blocks take a second element
BLOCK_LIMIT_CASES = (
    ("hyperFS", (1, 1, 1), 10, 11, torch.float64, "cluster"),
    ("hyperFS", (1, 1, 1), 13, 14, torch.float32, "cluster"),
    ("hyperFS", (1, 1, 1), 11, 12, torch.float64, "cluster"),
    ("hyperFS", (7, 7, 7), 11, 12, torch.float64, "cluster"),
    ("hyperFS", (1, 1, 1), 14, 15, torch.float32, "cluster"),
    ("linElas", (1, 1, 1), 14, 15, torch.float32, "cluster"),
    ("hyperFSIncomp-pressure", (1, 1, 1), 20, 2, torch.float64, "cluster"),
    ("hyperFS", (1, 1, 1), 22, 23, torch.float64, "gmem"),
    ("hyperFS", (7, 7, 7), 22, 23, torch.float64, "gmem"),
    ("hyperFS", (1, 1, 1), 28, 29, torch.float32, "gmem"))


def test_gmem_matches_plain_above_a_block(cuda):
    """The generic tile above a block's shared memory: the cluster body
    where one element needs two CTAs ((12, 12) and the pressure term's
    (21, 2) in float64, (15, 15) in float32) and at one CTA just below
    ((11, 11) float64, (14, 14) float32), the gmem body where no cluster
    of 8 CTAs holds one ((23, 23) float64, (29, 29) float32), against the
    plain float64 version, residual (with the stash) and J.v: float64 to
    1e-12 of max|ref|, float32 at the rule of test_kernel_matches_plain.
    The input amplitude shrinks with P^2, which the gradient of a random
    nodal field grows with, so that gradu stays ~1e-2 (at O(1) strain C is
    nearly singular and float32 rounding is amplified). Its plan in both
    modes is generic_plan's, with the workspace the wrapper allocates; the
    launches count under the body's path. Config takes degree 11 in
    float64 and degree 14 in float32 on CUDA."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for physics, faces, degree, Q, dtype, body in BLOCK_LIMIT_CASES:
        f = OperatorFactory(build_fespace(box_mesh(faces), degree),
                            dtype=torch.float64, device=cuda, q1d=Q)
        P = f.basis.P
        rng = np.random.default_rng(degree)
        amp = 3e-3 / faces[0] * (5 / P) ** 2
        u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes))
                                * amp, device=cuda) for _ in range(2))
        q64 = f.compute_qdata()
        pw = fa.pointwise(physics)
        conn = f.restr.conn
        ve0, st0 = fa.residual_plain(u, conn, q64, f.basis, PHYS, pw)
        jv0 = fa.jacobian_plain(v, conn, q64, st0, f.basis, PHYS, pw)
        b = Basis3D.create(P, Q, "gauss", dtype, device=cuda)
        q = q64.to(dtype)
        st_in = None if st0 is None else st0.to(dtype)
        path = f"generic_{body}"
        for jac in (False, True):
            p = fa.plan(jac, q, b, st_in if jac else None, pw)
            g = fa.generic_plan(P, Q, dtype, f.nelem, sms,
                                19 if jac and pw.stash else 10)
            assert (p.path, p.body, p.elems, p.threads, p.smem, p.tiles,
                    p.work, p.copy, p.cluster, p.clusters) == (
                path, body, g.elems, 256, g.smem, g.tiles, g.work, None,
                g.cluster, g.clusters)
            assert g.path == path and g.elems == 1
            if body == "gmem":
                assert g.tiles == min(f.nelem, fa.GMEM_BLOCKS_PER_SM * sms)
            else:
                assert g.work == 0 and g.smem <= fa.H100_SMEM_PER_BLOCK
                assert g.clusters == f.nelem and g.cluster >= 1
        fa.COUNTS.reset()
        ve, st = fa.residual(u.to(dtype), conn, q, b, PHYS, pw)
        jv = fa.jacobian(v.to(dtype), conn, q, st_in, b, PHYS, pw)
        torch.cuda.synchronize()
        assert fa.COUNTS.by_path == {("residual", path): 1,
                                     ("jacobian", path): 1}
        pairs = [(ve, ve0), (jv, jv0)] + ([(st, st0)] if pw.stash else [])
        for got, ref in pairs:
            err = (got.double() - ref).abs()
            mx = ref.abs().max()
            if dtype == torch.float64:
                assert float(err.max() / mx) <= 1e-12
            else:
                assert bool((err <= 2e-5 * ref.abs() + 1e-6 * mx).all())
    Config(problem="hyperFS", degree=11, device=cuda, dtype=torch.float64)
    Config(problem="hyperFS", degree=14, device=cuda)


# the cluster body at sizes the plan chooses (0) and given ones: (physics,
# box faces, degree, Q, dtype, cluster sizes, streams one word off 16
# bytes). Phase 19's shapes, (15, 15) float32 on 5^3 (125 elements) and
# (12, 12) float64 on 6^3 (216), and their (9, 9) levels, at every size
# their plans choose and at 1 (where one CTA holds an element), 2, 4 and
# 8; linElas (no stash); the pressure term's (21, 2), whose k = 8 leaves
# the last CTA no slab; a ragged (11, 10), where most sizes divide
# neither P nor Q^2; 343 elements at (12, 12), more clusters than the card
# runs at once
CLUSTER_CASES = (
    ("hyperFS", (5, 5, 5), 14, 15, torch.float32, (0, 2, 4, 8), False),
    ("hyperFS", (6, 6, 6), 11, 12, torch.float64, (0, 2, 4, 8), False),
    ("hyperFS", (5, 5, 5), 8, 9, torch.float32, (0, 1, 2, 4, 8), False),
    ("hyperFS", (6, 6, 6), 8, 9, torch.float64, (0, 1, 2, 4, 8), False),
    ("linElas", (1, 1, 1), 11, 12, torch.float64, (2, 8), False),
    ("hyperFSIncomp-pressure", (1, 1, 1), 20, 2, torch.float64, (2, 8),
     False),
    ("hyperSS", (2, 1, 1), 10, 10, torch.float64, (1, 3, 6, 7), False),
    ("hyperFS", (2, 1, 1), 11, 12, torch.float64, (2, 8), True),
    ("hyperFS", (2, 1, 1), 14, 15, torch.float32, (0, 4), True),
    ("hyperFS", (7, 7, 7), 11, 12, torch.float64, (0, 8), False))


@pytest.mark.parametrize("physics,faces,degree,Q,dtype,ks,shift",
                         CLUSTER_CASES)
def test_cluster_matches_plain(cuda, physics, faces, degree, Q, dtype, ks,
                               shift):
    """The cluster body (one element a thread-block cluster of k CTAs)
    against the plain float64 version, residual (with the stash) and J.v,
    at the tolerances and input scaling of
    test_gmem_matches_plain_above_a_block, at each cluster size of `ks`
    (0: the plan's; else fused_apply's override); its plan is
    generic_plan's, and the launches count under "generic_cluster". A size
    other than 1..8, or a size on a shape of another body, is refused."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    f = OperatorFactory(build_fespace(box_mesh(faces), degree),
                        dtype=torch.float64, device=cuda, q1d=Q)
    P = f.basis.P
    rng = np.random.default_rng(degree)
    amp = 3e-3 / faces[0] * (5 / P) ** 2
    u, v = (torch.as_tensor(rng.standard_normal((3, f.space.num_nodes))
                            * amp, device=cuda) for _ in range(2))
    q64 = f.compute_qdata()
    pw = fa.pointwise(physics)
    conn = f.restr.conn
    ve0, st0 = fa.residual_plain(u, conn, q64, f.basis, PHYS, pw)
    jv0 = fa.jacobian_plain(v, conn, q64, st0, f.basis, PHYS, pw)
    b = Basis3D.create(P, Q, "gauss", dtype, device=cuda)

    def moved(t):
        if not shift or t is None:
            return t
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    q = moved(q64.to(dtype))
    st_in = None if st0 is None else moved(st0.to(dtype))
    for jac in (False, True):
        p = fa.plan(jac, q, b, st_in if jac else None, pw)
        g = fa.generic_plan(P, Q, dtype, f.nelem, sms,
                            19 if jac and pw.stash else 10)
        assert (p.path, p.body, p.smem, p.tiles, p.cluster, p.clusters) == (
            "generic_cluster", "cluster", g.smem, g.tiles, g.cluster,
            g.clusters)
        assert p.clusters == f.nelem and p.tiles == f.nelem * p.cluster
    for k in ks:
        fa.COUNTS.reset()
        ve, st = fa.residual(u.to(dtype), conn, q, b, PHYS, pw, cluster=k)
        jv = fa.jacobian(v.to(dtype), conn, q, st_in, b, PHYS, pw,
                         cluster=k)
        torch.cuda.synchronize()
        assert fa.COUNTS.by_path == {("residual", "generic_cluster"): 1,
                                     ("jacobian", "generic_cluster"): 1}
        pairs = [(ve, ve0), (jv, jv0)] + ([(st, st0)] if pw.stash else [])
        for got, ref in pairs:
            err = (got.double() - ref).abs()
            mx = ref.abs().max()
            if dtype == torch.float64:
                assert float(err.max() / mx) <= 1e-12, (k, float(err.max()))
            else:
                assert bool((err <= 2e-5 * ref.abs() + 1e-6 * mx).all()), k
    for bad in (9, -1):
        with pytest.raises(RuntimeError, match="cluster size"):
            fa.jacobian(v.to(dtype), conn, q, st_in, b, PHYS, pw,
                        cluster=bad)
    f5 = OperatorFactory(build_fespace(box_mesh((1, 1, 1)), 6),
                         dtype=dtype, device=cuda)
    with pytest.raises(RuntimeError, match="cluster size"):
        fa.residual(torch.zeros((3, f5.space.num_nodes), dtype=dtype,
                                device=cuda), f5.restr.conn,
                    f5.compute_qdata(), f5.basis, PHYS, cluster=2)


def test_solve_on_gpu_matches_cpu(cuda):
    """The whole slice on the card in float64 against the CPU float64 path
    (the JAX-checked one): same Newton count, KSP within 1, error and
    energy to 1e-8."""
    def run(device):
        cfg = Config(problem="hyperFS", degree=2, test_mode=True,
                     box_faces=(2, 2, 2), multigrid="none", num_increments=1,
                     device=device, dtype=torch.float64)
        p = ElasticityProblem(cfg)
        info = p.solve()
        return info, p.mms_error(info.u), p.strain_energy(info.u)

    fa.COUNTS.reset()
    ig, eg, wg = run(cuda)
    assert fa.COUNTS.residual_launches > 0 and fa.COUNTS.jacobian_launches > 0
    ic, ec, wc = run("cpu")
    assert ig.converged and ic.converged
    assert ig.snes_iters == ic.snes_iters
    assert abs(ig.ksp_iters - ic.ksp_iters) <= 1
    assert abs(eg - ec) <= 1e-8 * ec and abs(wg - wc) <= 1e-8 * wc


@pytest.mark.parametrize("shape", gp.CHECK_SHAPES)
def test_gather_probes_bitwise(cuda, shape):
    """Each probe kernel against its plain version, bitwise: the script's
    shape, a ragged one (partial row blocks and tiles), a narrow table, one
    that spans a cluster of 8 (512 KB) and one cut into column slabs."""
    tab, idx = gp.probe_inputs(cuda, seed=1, shape=shape)
    for name, fn in gp.PROBES.items():
        got = fn(tab, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, gp.PLAIN[name](tab, idx)), name
        assert torch.equal(got.cpu(), tab.cpu()[idx.cpu().long()]), name


@pytest.mark.parametrize("shape", [gp.PROBE_SHAPE, (100, 300, 36),
                                   (2000, 4096, 64), (4000, 512, 256)])
def test_gather_probe_index_semantics(cuda, shape):
    """Out-of-range indices (0, W-1, -1, -W, W, W+7, -W-1, the int32
    extremes and random ones in [-2W, 2W)): every kernel bitwise equal to
    its plain version on the card and on the CPU (the JAX-checked one):
    NaN rows for K3/K4, clamped rows for K5, zero rows for K6 (a finite
    table)."""
    tab, idx = gp.probe_inputs(cuda, seed=2, shape=shape, out_of_range=True)
    for name, fn in gp.PROBES.items():
        got = fn(tab, idx)
        torch.cuda.synchronize()
        bits = got.view(torch.int32)
        assert torch.equal(bits, gp.PLAIN[name](tab, idx).view(torch.int32)), \
            name
        ref = gp.PLAIN[name](tab.cpu(), idx.cpu())
        assert torch.equal(bits.cpu(), ref.view(torch.int32)), name


def _held(name, tab, idx):
    """One probe against its plain version on the card and on the CPU
    (the JAX-checked one), by gather_probe.probe_equal: K3-K5 bitwise, K6
    NaN positions equal and every other value bitwise."""
    got = gp.PROBES[name](tab, idx)
    torch.cuda.synchronize()
    assert gp.probe_equal(name, got, gp.PLAIN[name](tab, idx)), name
    assert gp.probe_equal(name, got.cpu(),
                          gp.PLAIN[name](tab.cpu(), idx.cpu())), name


@pytest.mark.parametrize("shape", [gp.PROBE_SHAPE, (100, 300, 36),
                                   (2000, 4096, 64), (4000, 512, 256)])
def test_gather_probe_nonfinite(cuda, shape):
    """A table with inf, -inf, NaNs (canonical, payload, negative,
    signalling) and -0.0, their rows among in-range and out-of-range
    indices: K3-K5 keep every bit; K6 gives NaN where the one-hot product
    does (a non-finite value at another row of the column), +0.0 for
    -0.0."""
    tab, idx = gp.probe_inputs(cuda, seed=6, shape=shape, out_of_range=True,
                               nonfinite=True)
    for name in gp.PROBES:
        _held(name, tab, idx)


@pytest.mark.parametrize("R", [1, 255, 257, 4097])
def test_gather_loop_onehot_ragged_rows(cuda, R):
    """K5's flat grid and K6's groups at ragged row counts: the last block
    partly empty, one row, more rows than pieces a block."""
    W, C = 512, 128
    idx = torch.as_tensor(np.random.default_rng(R).integers(
        -2 * W, 2 * W, R, dtype=np.int32), device=cuda)
    tab = gp.probe_inputs(cuda, seed=R, shape=(W, 1, C))[0]
    for name in ("loop", "onehot"):
        _held(name, tab, idx)


def test_gather_loop_onehot_scalar_path(cuda):
    """4-byte pieces: a table 3 floats wide and a table one float off 16
    bytes; the staged probes refuse the misaligned one."""
    tab3, idx = gp.probe_inputs(cuda, seed=8, shape=(50, 257, 3),
                                out_of_range=True, nonfinite=True)
    tab, idx128 = gp.probe_inputs(cuda, seed=9, shape=(512, 256, 128),
                                  out_of_range=True, nonfinite=True)
    base = torch.empty(tab.numel() + 1, device=cuda)
    base[1:] = tab.reshape(-1)
    shifted = base[1:].view(tab.shape)
    assert shifted.data_ptr() % 16 == 4
    for name in ("loop", "onehot"):
        _held(name, tab3, idx)
        _held(name, shifted, idx128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gp.gather_take(shifted, idx128)
    # a table without columns: an empty output, nothing launched
    gp.COUNTS.reset()
    empty = torch.zeros((5, 0), device=cuda)
    for name in ("loop", "onehot"):
        assert gp.PROBES[name](empty, idx).shape == (idx.shape[0], 0)
    assert set(gp.COUNTS.launches.values()) == {0}


def test_gather_probe_counts_and_refusals(cuda):
    tab, idx = gp.probe_inputs(cuda)
    gp.COUNTS.reset()
    gp.gather_loop(tab, idx)
    gp.gather_onehot(tab, idx)
    assert gp.COUNTS.launches == {"take": 0, "take_along_axis": 0,
                                  "loop": 1, "onehot": 1}
    gp.gather_take(tab, idx)
    gp.gather_take_along_axis(tab, idx)
    # K6 at the probe's shape: one block a cluster (onehot_plan)
    assert gp.COUNTS.cluster_dims == {"take": (8, 1, 1),
                                      "take_along_axis": (8, 1, 1),
                                      "onehot": (1, 1, 1)}
    gp.gather_onehot(*gp.probe_inputs(cuda, shape=(4000, 512, 256)))
    assert gp.COUNTS.cluster_dims["onehot"] == (8, 1, 1)
    with pytest.raises(TypeError, match="int32"):
        gp.gather_take(tab, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        gp.gather_loop(tab.t().contiguous().t(), idx)
    # 25,000 rows a block of a cluster of 8: 400 KB even at 4 columns
    big = torch.zeros((200_000, 4), device=cuda)
    with pytest.raises(ValueError, match="use gather_loop"):
        gp.gather_take(big, idx)
    with pytest.raises(ValueError, match="use gather_loop"):
        gp.gather_take_along_axis(torch.zeros((512, 30), device=cuda), idx)
    assert torch.equal(gp.gather_loop(big, idx), big[idx])
    assert gp.COUNTS.launches == {"take": 1, "take_along_axis": 1,
                                  "loop": 2, "onehot": 2}
    # odd width: the loop kernel's scalar path
    tab3 = torch.randn((50, 3), device=cuda)
    assert torch.equal(gp.gather_loop(tab3, idx % 50), tab3[idx % 50])


def test_pmg_solve_on_gpu_matches_cpu(cuda):
    """Degree-2 p-MG solve (levels [1, 2], native quadrature, Chebyshev
    coarse) on the card in float64 against the CPU float64 path: same
    Newton count, KSP within 1, error and energy to 1e-8. Both draw the
    same eigenvalue start vectors (numpy, seeded)."""
    def run(device):
        cfg = Config(problem="hyperFS", degree=2, test_mode=True,
                     box_faces=(2, 2, 2), multigrid="logarithmic",
                     coarse_solve="chebyshev", num_increments=1,
                     device=device, dtype=torch.float64)
        p = ElasticityProblem(cfg)
        info = p.solve()
        return info, p.mms_error(info.u), p.strain_energy(info.u)

    fa.COUNTS.reset()
    ig, eg, wg = run(cuda)
    assert {("jacobian", 2, 2), ("jacobian", 3, 3)} <= set(fa.COUNTS.by_pq)
    ic, ec, wc = run("cpu")
    assert ig.converged and ic.converged
    assert ig.snes_iters == ic.snes_iters
    assert abs(ig.ksp_iters - ic.ksp_iters) <= 1
    assert abs(eg - ec) <= 1e-8 * ec and abs(wg - wc) <= 1e-8 * wc


def _solve_pair(cuda, **kw):
    """One solve on the card and on the CPU, both float64."""
    def run(device):
        p = ElasticityProblem(Config(device=device, dtype=torch.float64,
                                     **kw))
        info = p.solve()
        return p, info, p.strain_energy(info.u)

    fa.COUNTS.reset()
    pg, ig, wg = run(cuda)
    counts = dict(fa.COUNTS.by_physics)
    pc, ic, wc = run("cpu")
    assert ig.converged and ic.converged
    assert ig.snes_iters == ic.snes_iters
    assert abs(ig.ksp_iters - ic.ksp_iters) <= 1
    assert abs(wg - wc) <= 1e-8 * abs(wc)
    return pg, pc, ig, ic, counts


def test_amg_smoke_on_gpu_matches_cpu(cuda):
    """The reference smoke problem (linElas degree 3 on 3^3, p-MG [1, 2, 3]
    with the AMG coarse solve) on the card in float64 against the CPU
    float64 path: same counts, error and energy to 1e-8; the (2, 2) level-0
    apply of the AMG cycle ran as the linElas kernel."""
    pg, pc, ig, ic, counts = _solve_pair(
        cuda, problem="linElas", degree=3, test_mode=True,
        box_faces=(3, 3, 3))
    assert ("linElas", "jacobian", 2, 2) in counts
    eg, ec = pg.mms_error(ig.u), pc.mms_error(ic.u)
    assert abs(eg - ec) <= 1e-8 * ec


def test_incomp_clamp_on_gpu_matches_cpu(cuda):
    """hyperFSIncomp's clamp solve (degree 2 on 2^3, p-MG + AMG) on the card
    in float64 against the CPU: both terms' kernels ran, the pressure at
    (3, 1) and (2, 1)."""
    _, _, _, _, counts = _solve_pair(
        cuda, problem="hyperFSIncomp", degree=2, nu=0.49, E=1e6,
        forcing="none", box_faces=(2, 2, 2), bc_clamp=(6, 5),
        bc_clamp_translate={5: (0.05, 0.0, 0.0)}, num_increments=1,
        nu_smoother=0.3)
    pressure = "hyperFSIncomp-pressure"
    assert {(pressure, "residual", 3, 1), (pressure, "jacobian", 3, 1),
            (pressure, "jacobian", 2, 1), ("hyperFSIncomp", "jacobian", 2, 2),
            } <= set(counts)


def test_pcgamg_degree1_on_gpu_matches_cpu(cuda):
    """Degree 1 under the default schedule: CG preconditioned by the AMG
    V-cycle alone (PCGAMG), card vs CPU in float64."""
    _, _, ig, _, counts = _solve_pair(
        cuda, problem="linElas", degree=1, test_mode=True,
        box_faces=(6, 6, 6))
    assert ig.ksp_iters <= 15
    assert counts[("linElas", "jacobian", 2, 2)] > ig.ksp_iters


@pytest.mark.parametrize("kind", ["box", "scrambled"])
def test_diagnostics_on_gpu_match_cpu(cuda, kind):
    """ElasticityProblem.diagnostics on the card (a float32 problem: the
    diagnostics are float64 all the same) against the CPU float64 problem's
    on the same u: float64 on the card, every column to 1e-12 of its max
    |value|, columns 0-2 equal to u to 1e-15 (the node sums may add in
    another order)."""
    mesh = (scrambled_box_mesh((3, 3, 3), seed=3) if kind == "scrambled"
            else None)
    kw = dict(problem="hyperFS", degree=3, test_mode=True,
              box_faces=(3, 3, 3), multigrid="none")
    pg = ElasticityProblem(Config(**kw, device=cuda, dtype=torch.float32),
                           mesh=mesh)
    pc = ElasticityProblem(Config(**kw, device="cpu"), mesh=mesh)
    rng = np.random.default_rng(12)
    u = torch.as_tensor(rng.normal(size=(3, pc.fine_space.num_nodes)) * 1e-2)
    dg = pg.diagnostics(u.to(cuda))
    dc = pc.diagnostics(u)
    assert dg.dtype == torch.float64 and dg.device.type == "cuda"
    err = (dg.cpu() - dc).abs().amax(dim=0)
    assert bool((err <= 1e-12 * dc.abs().amax(dim=0)).all())
    assert float((dg[:, :3].cpu() - u.T).abs().max()) <= 1e-15 * float(
        u.abs().max())


def test_resume_on_gpu_matches_unbroken(cuda):
    """A hyperFS clamp on the card (float64, p-MG + AMG, four increments)
    stopped at load 0.5 and resumed in a fresh problem from the monitor's
    checkpoint, against the unbroken solve: the same SNES count, KSP within
    10% (the resumed AMG aggregates at another Jacobian), u to 1e-8."""
    kw = dict(problem="hyperFS", degree=2, nu=0.3, E=1.0, box_faces=(3, 3, 3),
              bc_clamp=(6, 5), bc_clamp_translate={5: (0.2, 0.0, 0.1)},
              num_increments=4, device=cuda, dtype=torch.float64)
    full = ElasticityProblem(Config(**kw)).solve()
    ck = {"floor": 0.0}

    def monitor(inc, load, res):
        if res.converged:
            ck.update(u=res.u, load=load,
                      floor=max(ck["floor"], float(res.rnorm)))

    first = ElasticityProblem(Config(**kw, stop_at_load=0.5)).solve(monitor)
    rest = ElasticityProblem(Config(**kw)).solve(
        u0=ck["u"].cpu().numpy(), start_load=ck["load"],
        floor_atol0=ck["floor"])
    assert ck["load"] == 0.5 and rest.u.device.type == "cuda"
    assert full.converged and rest.converged
    assert first.snes_iters + rest.snes_iters == full.snes_iters
    assert abs(first.ksp_iters + rest.ksp_iters - full.ksp_iters) <= \
        0.1 * full.ksp_iters
    assert float(torch.linalg.norm(rest.u - full.u)
                 / torch.linalg.norm(full.u)) <= 1e-8


# -- the distributed driver (parallel/) on the card --------------------------
DIST = dict(problem="hyperFS", degree=2, nu=0.3, E=1.0, test_mode=True,
            box_faces=(3, 3, 3), multigrid="logarithmic", num_increments=2)
KERNEL_PATHS = {"bulk", "async", "generic", "generic_gmem",
                "generic_cluster"}


def test_dist_nccl_world1_residual_matches_serial_kernel(cuda, tmp_path):
    """One NCCL rank in this process: residual_apply (the kernel on the
    interior batch; one rank has no boundary batch) against the serial
    kernel operator, float64, to 1e-12 of max |G|, every batch apply a
    kernel launch."""
    import torch.distributed as tdist

    from ceedpetscsolid_tpu_torch.parallel.driver import DistributedProblem

    if not tdist.is_nccl_available():
        pytest.skip("torch was built without NCCL")
    prob = ElasticityProblem(Config(**DIST, device=cuda, dtype=torch.float64))
    N = prob.fine_space.num_nodes
    u = torch.as_tensor(np.random.default_rng(4).standard_normal((3, N))
                        * 1e-3, device=cuda)
    G_ref, _ = prob._nonlinear_residual(u, prob.bc_values(1.0), prob.F)
    tdist.init_process_group("nccl", store=tdist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        dp = DistributedProblem(prob)
        fa.COUNTS.reset()
        G = dp.to_global(dp.residual_apply(dp.to_owned(u), 1.0))
        launches = fa.COUNTS.residual_launches
    finally:
        tdist.destroy_process_group()
    ref = G_ref.cpu().numpy()
    assert np.abs(G - ref).max() <= 1e-12 * np.abs(ref).max()
    assert launches == dp.batch_applies["residual"] > 0


@pytest.fixture(scope="module")
def gloo4_on_card(tmp_path_factory):
    """Four gloo ranks on cuda:0: the residual at a seeded u and the p-MG
    + AMG solve, float64, and the float64 plain (CPU) problem's."""
    from ceedpetscsolid_tpu_torch import native
    from ceedpetscsolid_tpu_torch.parallel import launch, tasks

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on a GPU")
    native.build()
    fa._library()                   # built once, before the ranks load it
    cpu = ElasticityProblem(Config(**DIST, device="cpu"))
    N = cpu.fine_space.num_nodes
    u = np.random.default_rng(4).standard_normal((3, N)) * 1e-3
    G, _ = cpu._nonlinear_residual(torch.as_tensor(u), cpu.bc_values(1.0),
                                   cpu.F)
    out = launch.run(tasks.problem_task, 4, "gloo", "cuda:0",
                     tmp_path_factory.mktemp("store"),
                     args=(dict(DIST, dtype=torch.float64),
                           [("residual", (u, 1.0)), ("solve", {})]))
    return out, G.numpy(), cpu.solve()


def test_dist_gloo4_on_card_matches_plain(gloo4_on_card):
    """Residual to 1e-12 of max |G| and solution to 1e-10 of the float64
    plain operator's serial solve (the distributed p-MG integrates its
    levels at the fine quadrature, the serial one at their own)."""
    out, G, info = gloo4_on_card
    assert np.abs(out["residual"] - G).max() <= 1e-12 * np.abs(G).max()
    assert out["solve"]["info"]["converged"]
    u = info.u.numpy()
    assert np.abs(out["solve"]["u"] - u).max() <= 1e-10 * np.abs(u).max()


def test_dist_gloo4_every_rank_launches_the_kernel(gloo4_on_card):
    """Every rank launched the fused kernel in both jobs, by kernel paths
    only, once per batch apply: no batch ran the plain version."""
    out, _, _ = gloo4_on_card
    for job in ("residual", "solve"):
        for c in out[job + "_counts"]:
            assert set(p for _, p in c["by_path"]) <= KERNEL_PATHS
            for mode in ("residual", "jacobian") if job == "solve" else (
                    "residual",):
                assert c["launches"][mode] == c["batch_applies"][mode] > 0


def test_weak_scaling_fixed_step_on_one_nccl_rank(cuda, tmp_path):
    """The jax series' n = 1 point (hyperFS p3 on 24 x 24 x 4, p-MG +
    AMG, float32) as the fixed_step job on one NCCL rank in this process:
    every timed step ran 10 CG iterations, and every batch of every phase
    was a fused-kernel launch."""
    import torch.distributed as tdist

    from ceedpetscsolid_tpu_torch import native
    from ceedpetscsolid_tpu_torch.utils import weak_scaling as ws

    if not tdist.is_nccl_available():
        pytest.skip("torch was built without NCCL")
    native.build()
    rec = ws.weak_point("jax", 1, "nccl", "cuda", tmp_path / "store", reps=2,
                        dtype=torch.float32, in_process=True)
    assert rec["ksp_its"] == [ws.KSP_ITS] * 2 and rec["fixed_work"]
    assert rec["dofs"] == 207_831 and rec["elements_per_rank"] == [2304]
    assert rec["fused_only"]
    assert not ws.weak_failures(rec, on_card=True)
