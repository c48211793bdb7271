"""The high degrees: every (P, Q) whose one-element generic tile exceeds the
shared memory of an H100 block, which the CUDA fused apply runs on the
generic tile's cluster body ("cluster": an element in the shared memory of
a thread-block cluster) and, where no cluster of 8 CTAs holds one, on its
global-memory body ("gmem").

CPU, against the JAX package:
  * the port's plain residual (with its stash) and J.v against the JAX XLA
    structured path in float64, to 1e-12 of max|ref|, at (12, 12) hyperFS
    and hyperFSIncomp's mu part, (15, 15) hyperFS (and there the port's
    float32 plain version against float64 at chip_smoke.py phase 3's
    rule, 2e-5 |ref| + 1e-6 max|ref|), and hyperFSIncomp's pressure term
    at (21, 2), each on one element of the 1^3 box. The inputs' amplitude
    shrinks with P^2, which the gradient of a random nodal field grows
    with, so that gradu stays ~1e-2 (at O(1) strain C is nearly singular);
  * the slice as a whole: hyperFS degree 11, float64, -test on the 1^3 box
    (5,184 DoF), the port's p-MG + AMG ElasticityProblem.solve against the
    JAX package's serial Jacobi-CG solve of the same problem (u to 1e-10
    relative, strain energy to 1e-10). Its p = 1 level has no free DOF.
Pure Python: above P, Q = 8 the plan picks the cluster body, at two or
more CTAs exactly where one element's buffers exceed 232,448 bytes, and
the gmem body only where no cluster of 8 CTAs holds one; the four
constructors and the interop converters take no default device; the
eigenvalue estimate of a level without free DOFs gives JAX's NaN bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu.mesh.fespace import build_fespace as jbuild
from ceedpetscsolid_tpu.models import Physics as JPhysics
from ceedpetscsolid_tpu.models import get_model as jget_model
from ceedpetscsolid_tpu.ops.operator import OperatorFactory as JFactory
from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu.solve import cg as jcg
from ceedpetscsolid_tpu_torch import interop
from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace as tbuild
from ceedpetscsolid_tpu_torch.ops import fused_apply
from ceedpetscsolid_tpu_torch.ops.assembly import CSRAssembler
from ceedpetscsolid_tpu_torch.ops.basis import Basis3D
from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory as TFactory
from ceedpetscsolid_tpu_torch.ops.restriction import Restriction
from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem
from ceedpetscsolid_tpu_torch.solve import cg as tcg
from ceedpetscsolid_tpu_torch.solve.amg import AMGPreconditioner
from test_torch_mesh import mesh_pair

JPHYS = JPhysics(nu=0.3, E=1.0)
TPHYS = interop.physics_from_jax(JPHYS)


@pytest.mark.parametrize("physics,degree,q1d", [
    ("hyperFS", 11, None),                   # (12, 12)
    ("hyperFSIncomp", 11, None),             # its mu part at (12, 12)
    ("hyperFS", 14, None),                   # (15, 15)
    ("hyperFSIncomp-pressure", 20, 2),       # (21, 2): -qextra 1
])
def test_plain_matches_jax_at_gmem_shapes(physics, degree, q1d):
    jm, tm = mesh_pair("box", 1)
    jf = JFactory([jbuild(jm, degree)], dtype=jnp.float64, use_pallas=False,
                  use_spectral=False, q1d=q1d)
    tf = TFactory(tbuild(tm, degree), dtype=torch.float64, device="cpu",
                  q1d=q1d)
    P, Q = tf.basis.P, tf.basis.Q
    assert fused_apply.generic_plan(P, Q, torch.float64, 1).body == "cluster"
    pw = fused_apply.pointwise(physics)
    jmod = jget_model(physics.removesuffix("-pressure"))
    pre = "pressure_" if physics.endswith("-pressure") else ""
    rng = np.random.default_rng(degree)
    amp = 5e-3 * (5 / P) ** 2
    u, v = (rng.standard_normal((3, jf.fine.space.num_nodes)) * amp
            for _ in range(2))
    jq = jf.compute_qdata()
    jr, jst = jf.make_residual_structured(
        getattr(jmod, pre + "residual_planes"), JPHYS)(
        jnp.asarray(u), jq, jf.fine.srestr, jf.fine.sgrad)
    jjv = jf.make_jacobian_structured(
        getattr(jmod, pre + "jacobian_planes"), JPHYS)(
        jnp.asarray(v), jq, jst, jf.fine.srestr, jf.fine.sgrad)
    tq = interop.qdata_from_jax(jq, tf.nelem, tf.Q3, device="cpu")
    st_in = interop.stash_from_jax(jst, tf.nelem, tf.Q3, device="cpu")
    tu, tv = (interop.u_from_jax(x, device="cpu") for x in (u, v))
    conn = tf.restr.conn
    ve, st = fused_apply.residual(tu, conn, tq, tf.basis, TPHYS, pw)
    jv = fused_apply.jacobian(tv, conn, tq, st_in, tf.basis, TPHYS, pw)
    scatter = tf.restr.scatter_add
    refs = {"residual": np.asarray(jr), "stash": st_in.numpy(),
            "J.v": np.asarray(jjv)}
    for name, got in (("residual", scatter(ve)), ("stash", st),
                      ("J.v", scatter(jv))):
        ref = refs[name]
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-12, (name, err)
    if degree == 14:
        # float32 plain against float64 (chip_smoke.py phase 3's rule)
        f32 = torch.float32
        b32 = Basis3D.create(P, Q, "gauss", f32, device="cpu")
        q32 = tq.to(f32)
        ve32, st32 = fused_apply.residual(tu.to(f32), conn, q32, b32, TPHYS,
                                          pw)
        jv32 = fused_apply.jacobian(tv.to(f32), conn, q32, st_in.to(f32),
                                    b32, TPHYS, pw)
        for got, ref in ((ve32, ve), (st32, st), (jv32, jv)):
            err = (got.double() - ref).abs()
            assert bool((err <= 2e-5 * ref.abs()
                         + 1e-6 * ref.abs().max()).all())


def test_degree11_solve_matches_jax_serial():
    """The slice: hyperFS degree 11 (levels [1, 2, 4, 8, 11], the AMG
    coarse solve on a p = 1 level whose nodes are all on the boundary)
    against JAX's Jacobi-CG solve of the same problem, which compiles in
    ~25 s where its p-MG solve would take minutes."""
    kw = dict(problem="hyperFS", degree=11, nu=0.3, E=1.0, test_mode=True,
              box_faces=(1, 1, 1), num_increments=1)
    prob = ElasticityProblem(Config(**kw, device="cpu", dtype=torch.float64))
    info = prob.solve()
    assert prob.level_degrees == [1, 2, 4, 8, 11]
    assert info.dofs == 5_184 and info.converged
    jprob = JProblem(JConfig(**kw, multigrid="none"))
    jinfo = jprob.solve()
    assert jinfo.converged
    u, ju = info.u.numpy(), np.asarray(jinfo.u)
    assert np.linalg.norm(u - ju) <= 1e-10 * np.linalg.norm(ju)
    e, je = float(prob.strain_energy(info.u)), float(
        jprob.strain_energy(jinfo.u))
    assert abs(e - je) <= 1e-10 * abs(je)


@pytest.mark.parametrize("P,Q,dtype,words", [
    (12, 12, torch.float64, 31_104),    # 9 P Q^2 + 9 Q^3
    (15, 15, torch.float32, 60_750),
    (21, 2, torch.float64, 33_075),     # 3 P^3 + 6 P^2 Q
    (11, 11, torch.float64, 0),         # one block's: 193,600 bytes
    (14, 14, torch.float32, 0),         # 199,136 bytes
    (12, 12, torch.float32, 0),
])
def test_plan_takes_gmem_exactly_above_a_block(P, Q, dtype, words):
    """Above P, Q = 8 generic_plan picks the gmem body exactly where no
    cluster of 8 CTAs holds an element (each CTA's share: B, D, B^T, D^T
    and its regions A and B, fused_apply.cluster_plan, within 232,448
    bytes), over P, Q = 2..24, 1..24 in both dtypes, and the cluster body
    elsewhere. `words`: one element's buffers A and B as one block would
    hold them (max(3 P^3, 9 P Q^2) + max(6 P^2 Q, 9 Q^3)) where they
    exceed a block (PR 11's gmem shapes, the cluster body's at two CTAs or
    more), 0 where one CTA holds the element: at phase 19's meshes, 125
    elements at (15, 15) f32 on 5^3 and 216 at (12, 12) f64 on 6^3, and
    one element and 343, the plan takes one cluster an element, of the
    fewest CTAs that fit, doubled while a CTA takes more than 115,712
    bytes (two would not share an SM) or the grid has fewer CTAs than the
    card's 132 SMs, and no workspace."""
    for p in range(2, 25):
        for q in range(1, 25):
            for dt in (torch.float32, torch.float64):
                w = dt.itemsize
                fits = fused_apply.cluster_fewest(p, q, w) > 0
                gmem = max(p, q) > 8 and not fits
                plan = fused_apply.generic_plan(p, q, dt, 216)
                assert (plan.body == "gmem") == gmem, (p, q, dt)
                assert (plan.path == "generic_gmem") == gmem
                assert (plan.body == "cluster") == (max(p, q) > 8 and fits)
                if gmem:
                    assert fused_apply.cluster_plan(
                        p, q, w, 8).smem > 232_448
    w = dtype.itemsize
    one = max(3 * P ** 3, 9 * P * Q * Q) + max(6 * P * P * Q, 9 * Q ** 3)
    assert (w * one > 232_448) == (words > 0)
    fewest = fused_apply.cluster_fewest(P, Q, w)
    assert (fewest >= 2) == (words > 0) and words in (0, one)
    for nelem in (1, 125, 216, 343):
        g = fused_apply.generic_plan(P, Q, dtype, nelem)
        k = fewest
        while 2 * k <= 8 and (
                fused_apply.cluster_plan(P, Q, w, k).smem > 115_712
                or nelem * k < 132):
            k *= 2
        assert (g.body, g.elems, g.threads, g.tiles, g.work, g.cluster,
                g.clusters) == ("cluster", 1, 256, nelem * k, 0, k, nelem)
        assert g.smem == fused_apply.cluster_plan(P, Q, w, k).smem <= \
            232_448
    fused_apply.require_fits("hyperFS", P, Q)


def test_constructors_take_no_default_device():
    """AMGPreconditioner, Basis3D.create, Restriction and CSRAssembler have
    no default device: without one they raise TypeError (a default of the
    CPU would put a caller that forgets it on the CPU)."""
    conn = np.arange(8).reshape(1, 8)
    with pytest.raises(TypeError):
        AMGPreconditioner(torch.float64)
    with pytest.raises(TypeError):
        Basis3D.create(2, 2, "gauss", torch.float64)
    with pytest.raises(TypeError):
        Restriction(conn, 8)
    with pytest.raises(TypeError):
        CSRAssembler(conn, 8, np.zeros(24, bool))
    AMGPreconditioner(torch.float64, "cpu")
    Basis3D.create(2, 2, "gauss", torch.float64, device="cpu")
    Restriction(conn, 8, device="cpu")
    CSRAssembler(conn, 8, np.zeros(24, bool), device="cpu")


def test_interop_converters_take_no_default_device():
    """The JAX-to-port state converters have no default device: without
    one they raise TypeError, as the constructors above do."""
    a3 = np.zeros((3, 8))
    q = np.zeros((10, 1, 8))
    st = np.zeros((9, 1, 8))
    calls = (
        (interop.qdata_from_jax, (q, 1, 8)),
        (interop.stash_from_jax, (st, 1, 8)),
        (interop.u_from_jax, (a3,)),
        (interop.pc_from_jax, ([a3], [(0.1, 1.0)])),
        (interop.mask_from_jax, (np.zeros((3, 8), bool),)),
        (interop.stash_pair_from_jax, (st, np.zeros((9, 1, 1)), 1, 8)),
        (interop.owned_from_jax, (np.zeros((2, 3, 4)), 1)),
    )
    for fn, args in calls:
        with pytest.raises(TypeError):
            fn(*args)
        out = fn(*args, device="cpu")
        for t in out[0] if fn is interop.pc_from_jax else (
                out if isinstance(out, tuple) else (out,)):
            assert t.device.type == "cpu"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eig_estimate_without_free_dofs_gives_jax_nan(dtype):
    """A level whose DOFs are all constrained (its operator 0 on the masked
    space, the diagonal set to 1) has no Lanczos step: the port returns
    JAX's bounds, NaN, which its AMG coarse solve never reads."""
    lo_j, hi_j = jcg.estimate_extreme_eigs(
        lambda v: 0 * v, jnp.ones((3, 8)), (3, 8), jnp.float64)
    assert np.isnan(float(lo_j)) and np.isnan(float(hi_j))
    lo, hi = tcg.estimate_extreme_eigs(
        lambda v: 0 * v, torch.ones((3, 8), dtype=dtype), (3, 8), dtype)
    assert np.isnan(lo) and np.isnan(hi)
