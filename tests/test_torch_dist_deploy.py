"""The distributed deployment's pieces on the CPU: the ranks' CPU binding
plan (parallel/launch.py) on made-up topologies, the device AMG refresh on
every rank against the native refresh, and the distributed solve as a
request of utils/timing against the port's serial solve. Two gloo ranks,
float64, boxes of a few elements; no JAX."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ceedpetscsolid_tpu_torch import native
from ceedpetscsolid_tpu_torch import problem as tproblem
from ceedpetscsolid_tpu_torch.models.base import Mat3
from ceedpetscsolid_tpu_torch.ops.assembly import (diagonal_weights,
                                                   element_diagonal_of,
                                                   element_matrices_of,
                                                   pointwise_tangent)
from ceedpetscsolid_tpu_torch.parallel import launch, tasks
from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem

REPO = Path(__file__).resolve().parents[1]
NODE0, NODE1 = list(range(0, 16)), list(range(16, 32))
# p2 hyperFS -test, p-MG [1, 2] + AMG at the fine quadrature (the
# distributed driver integrates every level there)
HYPERFS = dict(problem="hyperFS", degree=2, nu=0.3, E=1.0, test_mode=True,
               num_increments=1, multigrid="logarithmic",
               level_quadrature="fine")
# the request's spans that the serial solve's records carry too
SERIAL_SPANS = {"solve", "newton/step", "newton/residual", "pc",
                "pc/tangent", "pc/mg/p1/diag", "pc/mg/p2/diag",
                "pc/mg/p1/eig", "pc/mg/p2/eig", "pc/amg/elem_mats", "cg",
                "cg/iter", "cg/wait"}
DIST_SPANS = {f"dist/{k}/{p}" for k in ("all_to_all", "all_reduce",
                                        "all_gather")
              for p in ("issue", "wait")}


@pytest.fixture(scope="module", autouse=True)
def _amg_library():
    native.build()


def _disjoint(plan):
    seen = set()
    for cpus in plan:
        assert cpus and not seen.intersection(cpus)
        seen.update(cpus)


@pytest.mark.parametrize("cards, allowed, want", [
    # four cards on two nodes: two ranks a node, eight CPUs each
    ([NODE0, NODE0, NODE1, NODE1], NODE0 + NODE1,
     [NODE0[:8], NODE0[8:], NODE1[:8], NODE1[8:]]),
    # two cards on two nodes: a node each
    ([NODE0, NODE1], NODE0 + NODE1, [NODE0, NODE1]),
    # cards listed against the nodes' order
    ([NODE1, NODE0], NODE0 + NODE1, [NODE1, NODE0]),
    # a mask smaller than the host: each node's allowed CPUs shared out
    ([NODE0, NODE0, NODE1, NODE1], [0, 1, 2, 3, 4, 5, 16, 17, 18, 19],
     [[0, 1, 2], [3, 4, 5], [16, 17], [18, 19]]),
    # a node whose allowed CPUs do not go round its ranks: an even split
    # of the whole mask
    ([NODE0, NODE0, NODE1, NODE1], [0] + NODE1,
     [[0, 16, 17, 18, 19], [20, 21, 22, 23], [24, 25, 26, 27],
      [28, 29, 30, 31]]),
    # a card whose topology cannot be read: an even split of the mask
    ([NODE0, None, NODE1, NODE1], NODE0 + NODE1,
     [NODE0[:8], NODE0[8:], NODE1[:8], NODE1[8:]]),
    ([None, None], list(range(6)), [[0, 1, 2], [3, 4, 5]]),
    # fewer CPUs than ranks: one each, shared
    ([None, None], [3], [[3], [3]]),
])
def test_binding_plan(cards, allowed, want):
    plan = launch.plan_binding(set(allowed), cards)
    assert plan == want
    if len(allowed) >= len(cards):
        _disjoint(plan)
    for cpus in plan:
        assert set(cpus) <= set(allowed)


def test_cpu_list():
    assert launch.cpu_list("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]
    assert launch.cpu_list("") == []


def _fake_card(monkeypatch, root, node, cpulist):
    props = types.SimpleNamespace(pci_domain_id=0, pci_bus_id=0x18,
                                  pci_device_id=0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props)
    dev = root / "bus" / "pci" / "devices" / "0000:18:00.0"
    dev.mkdir(parents=True)
    (dev / "numa_node").write_text(f"{node}\n")
    if cpulist is not None:
        (dev / "local_cpulist").write_text(cpulist)
    nd = root / "devices" / "system" / "node" / f"node{node}"
    nd.mkdir(parents=True)
    (nd / "cpulist").write_text("16-31\n")


def test_card_topology_from_sysfs(tmp_path, monkeypatch):
    _fake_card(monkeypatch, tmp_path / "a", 1, "16-19,48-51\n")
    assert launch.card_topology(0, str(tmp_path / "a")) == (
        1, [16, 17, 18, 19, 48, 49, 50, 51])
    # no local_cpulist: the node's CPU list
    _fake_card(monkeypatch, tmp_path / "b", 1, None)
    assert launch.card_topology(0, str(tmp_path / "b")) == (1, NODE1)
    # no such device in sysfs, or no PCI id: unreadable
    assert launch.card_topology(0, str(tmp_path / "c")) == (None, None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace())
    assert launch.card_topology(0, str(tmp_path / "a")) == (None, None)


def test_bound_rank_sizes_its_pools_to_its_cpus():
    """A process started as `run` starts a rank (THREAD_ENV at the
    smallest rank's CPU count) and bound by bind_rank: every thread on its
    CPUs, and torch's threads and the OpenMP and BLAS pools in effect
    (threadpoolctl's reading, where it is installed) at their count."""
    cpus = sorted(os.sched_getaffinity(0))[:2]
    n = len(cpus)
    code = (
        "import os, numpy, torch\n"
        "from ceedpetscsolid_tpu_torch.parallel import launch\n"
        f"n = launch.bind_rank({cpus!r})\n"
        "masks = {tuple(sorted(os.sched_getaffinity(int(t))))\n"
        "         for t in os.listdir('/proc/self/task')}\n"
        "try:\n"
        "    from threadpoolctl import threadpool_info\n"
        "    pools = sorted({p['num_threads'] for p in threadpool_info()})\n"
        "except ImportError:\n"
        "    pools = [n]\n"
        "print(n, torch.get_num_threads(), sorted(masks), pools)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               **dict.fromkeys(launch.THREAD_ENV, str(n)))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         env=env)
    assert out.stdout.split("\n")[0] == f"{n} {n} {[tuple(cpus)]} {[n]}"


def test_distributed_device_refresh_matches_native(tmp_path):
    """Every refresh after the first build computes the levels on the
    device: each level's float64 CSR values, its matrix and the diagonals'
    inverses equal the native refresh's bit for bit, lambda_max to 1e-12
    and the coarse pseudo-inverse to 1e-10 of its largest entry (eigh
    against numpy's pinv: tests/amg_refresh_pair.py's bounds). The box
    (4, 4, 8) is the smallest whose p = 1 space the AMG coarsens once."""
    cfg = dict(HYPERFS, box_faces=(4, 4, 8))
    out = launch.run(tasks.problem_task, 2, "gloo", "cpu", tmp_path,
                     args=(cfg, [("refresh", ((0, 1, 2), 1e-3))]))
    first, *later = out["refresh"]
    assert "amg.device_refreshes" not in first["counts"]
    for r in later:
        assert r["counts"]["amg.device_refreshes"] == 1
        assert len(r["values"]) == len(r["native_values"]) >= 2
        for got, ref in zip(r["values"], r["native_values"]):
            assert np.array_equal(got, ref)
        *levels, coarse = r["device"]
        *nlevels, ncoarse = r["native"]
        for got, ref in zip(levels, nlevels):
            assert set(got) == set(ref)
            for k in set(got) - {"lam"}:
                assert np.array_equal(got[k], ref[k]), k
            if "lam" in ref:
                assert abs(got["lam"] - ref["lam"]) <= 1e-12 * abs(ref["lam"])
        assert np.abs(coarse - ncoarse).max() <= \
            1e-10 * np.abs(ncoarse).max()


def test_distributed_solve_is_a_request_and_matches_serial(tmp_path):
    """Two solves on two ranks: the first builds the AMG natively, the
    second refreshes it on the device at every Newton step. Each record
    carries the serial path's spans, the exchanges' spans and counters;
    the answer and the SNES / KSP counts are the serial solve's (KSP up
    to 2 more, tests/test_torch_dist_solve.py)."""
    cfg = dict(HYPERFS, box_faces=(2, 2, 4))
    out = launch.run(tasks.problem_task, 2, "gloo", "cpu", tmp_path,
                     args=(cfg, [("solve", {"repeat": 2})]))
    serial = ElasticityProblem(Config(**cfg, device="cpu")).solve()
    info = out["solve"]["info"]
    assert info["converged"]
    assert info["newton_iters"] == serial.snes_iters
    assert serial.ksp_iters <= info["ksp_iters"] <= serial.ksp_iters + 2
    u = out["solve"]["u"]
    assert np.abs(u - serial.u.numpy()).max() <= 1e-10
    first, second = out["solve"]["records"]
    for rec in (first, second):
        assert rec["name"] == "solve"
        assert SERIAL_SPANS | DIST_SPANS <= set(rec["seconds"])
        c = rec["counts"]
        assert c["dist.exchanges"] > 0 and c["dist.bytes"] > 0
        assert c["pc.builds"] == info["newton_iters"]
        assert c["cg.iterations"] == info["ksp_iters"]
    assert first["counts"].get("amg.device_refreshes", 0) == \
        first["counts"]["pc.builds"] - 1
    assert {"pc/amg/d2h", "pc/amg/native", "pc/amg/upload"} <= \
        set(first["seconds"])
    assert second["counts"]["amg.device_refreshes"] == \
        second["counts"]["pc.builds"]
    assert {"pc/amg/galerkin", "pc/amg/lam", "pc/amg/coarse"} <= \
        set(second["seconds"])
    assert not {"pc/amg/d2h", "pc/amg/native", "pc/amg/upload"} & \
        set(second["seconds"])
    # the StageLog's stages as before, the device refresh's beside them
    st = info["stage_seconds"]
    assert st["refresh_amg: device refresh"] > 0
    assert st["refresh_amg: native setup"] == st["refresh_amg: d2h"] == 0


# the oracle: the element diagonals and element matrices as nine calls of
# the qfunction make them, one a unit gradient
def _nine_call_diagonal(qf, phys, basis, qdata, stash):
    """(3, nelem, P3) element diagonals: K's (c, :, c, :) slices from nine
    applications of qf."""
    BB = diagonal_weights(basis)
    nelem, Q3 = qdata.shape[1], qdata.shape[2]
    st = None if stash is None else Mat3(stash.unbind(0))
    diag_e = torch.zeros((3, nelem, basis.P3), dtype=qdata.dtype)
    du = torch.zeros((3, 3, nelem, Q3), dtype=qdata.dtype)
    for c2 in range(3):
        for d2 in range(3):
            du[c2, d2] = 1.0
            Krow = qf(du, qdata, st, phys)[c2]
            du[c2, d2] = 0.0
            diag_e[c2] += torch.einsum("qpa,aeq->ep", BB[..., d2], Krow)
    return diag_e


def _nine_call_matrices(qf, phys, basis, qdata, stash):
    """(nelem, 3 P3, 3 P3) element matrices from K stacked from nine
    applications of qf."""
    nelem, Q3 = qdata.shape[1], qdata.shape[2]
    st = None if stash is None else Mat3(stash.unbind(0))
    cols = []
    for c2 in range(3):
        row = []
        for d2 in range(3):
            du = torch.zeros((3, 3, nelem, Q3), dtype=qdata.dtype)
            du[c2, d2] = 1.0
            row.append(qf(du, qdata, st, phys))
        cols.append(torch.stack(row, dim=0))
    return element_matrices_of(torch.stack(cols, dim=0), basis.grad)


def _oracle_rules(prob, l, stash, stash_nats):
    """[(qf, qdata, stash, basis, restr)] of level l's operator parts at
    the problem's rules, the pressure part last."""
    lvl = prob.factory.levels[l]
    if prob._nat_level(l):
        sn = (stash_nats[l] if stash_nats is not None else
              prob.factory.stash_to_native(prob._mu(stash), l))
        parts = [(prob.model.jacobian_qf, prob._qdata_nat[l], sn,
                  lvl.nat_basis)]
    else:
        parts = [(prob.model.jacobian_qf, prob.qdata, prob._mu(stash),
                  lvl.basis)]
    if prob.composite:
        parts.append((prob.model.pressure_jacobian_qf, prob.qdata_p,
                      stash[1], prob.pfactory.levels[l].basis))
    return parts


def _oracle_level_diag(prob, l, stash, stash_nats):
    """ElasticityProblem.level_diag from the nine-call element diagonals."""
    restr = prob.factory.levels[l].restr
    d = None
    for qf, qd, st, b in _oracle_rules(prob, l, stash, stash_nats):
        dp = restr.scatter_add(
            _nine_call_diagonal(qf, prob._diag_phys, b, qd, st))
        d = dp if d is None else d + dp
    return d


def _oracle_p1_values(prob, stash, stash_nats=None):
    """ElasticityProblem.p1_values from the nine-call element matrices."""
    em = None
    for qf, qd, st, b in _oracle_rules(prob, 0, stash, stash_nats):
        e = _nine_call_matrices(qf, prob.phys, b, qd, st)
        em = e if em is None else em + e
    return prob._assembler0.assemble_values(em).to(torch.float64)


@pytest.mark.parametrize("level_quadrature", ["native", "fine"])
@pytest.mark.parametrize("problem, dtype", [
    ("hyperFS", torch.float64), ("hyperFS", torch.float32),
    ("hyperFSIncomp", torch.float64), ("hyperFSIncomp", torch.float32)])
def test_pointwise_tangent_matches_nine_calls(problem, dtype,
                                              level_quadrature):
    """The pointwise Jacobian, one qfunction call over the nine unit
    gradients, gives every element diagonal and the element matrices of
    the nine-call path bit for bit: at every rule either driver uses (the
    fine rule with every level's basis, as the distributed driver
    integrates, and each native level rule), for each operator of a
    composite model; and the serial problem's level diagonals and p = 1
    values equal the nine-call ones."""
    prob = ElasticityProblem(Config(**dict(
        HYPERFS, problem=problem, degree=4, box_faces=(2, 2, 3),
        level_quadrature=level_quadrature), dtype=dtype, device="cpu"))
    nlev = len(prob.spaces)
    assert prob._use_native_levels == (level_quadrature == "native")
    gen = torch.Generator().manual_seed(5)

    def stash_at(qdata):
        return 0.05 * torch.randn((9, *qdata.shape[1:]), generator=gen,
                                  dtype=dtype)

    mu = stash_at(prob.qdata)
    nats = [prob.factory.stash_to_native(mu, l) if prob._nat_level(l)
            else None for l in range(nlev)]
    rules = [(prob.model.jacobian_qf, prob.qdata, mu,
              [lv.basis for lv in prob.factory.levels])]
    rules += [(prob.model.jacobian_qf, prob._qdata_nat[l], nats[l],
               [prob.factory.levels[l].nat_basis])
              for l in range(nlev) if prob._nat_level(l)]
    stash = mu
    if prob.composite:
        stash = (mu, stash_at(prob.qdata_p))
        rules.append((prob.model.pressure_jacobian_qf, prob.qdata_p,
                      stash[1], [lv.basis for lv in prob.pfactory.levels]))
    assert len(rules) == 1 + (nlev - 1) * prob._use_native_levels + \
        prob.composite
    for qf, qdata, st, bases in rules:
        K = pointwise_tangent(qf, prob.phys, qdata, st)
        for b in bases:
            assert torch.equal(
                element_diagonal_of(K, diagonal_weights(b)),
                _nine_call_diagonal(qf, prob.phys, b, qdata, st))
            assert torch.equal(
                element_matrices_of(K, b.grad),
                _nine_call_matrices(qf, prob.phys, b, qdata, st))
    for l in range(nlev):
        assert torch.equal(prob.level_diag(l, stash, nats),
                           _oracle_level_diag(prob, l, stash, nats))
    assert torch.equal(prob.p1_values(stash),
                       _oracle_p1_values(prob, stash))


def test_serial_solve_matches_nine_call_oracle(monkeypatch):
    """A hyperFS p-MG [1, 2, 4] clamp solve in float64 with native levels:
    SNES, KSP and u equal those of the same solve fed the nine-call
    oracle's level diagonals and p = 1 values; the tangent path makes one
    pointwise tangent a rule (three) a preconditioner build."""
    cfg = Config(problem="hyperFS", degree=4, forcing="none",
                 box_faces=(2, 2, 2), bc_clamp=(6, 5),
                 bc_clamp_translate={5: (0.0, 0.0, 0.05)}, num_increments=2,
                 device="cpu")
    made = [0]

    def counted(*args):
        made[0] += 1
        return pointwise_tangent(*args)

    monkeypatch.setattr(tproblem, "pointwise_tangent", counted)
    prob = ElasticityProblem(cfg)
    got = prob.solve()
    assert got.converged and made[0] == 3 * prob.pc_setups > 0

    oracle = ElasticityProblem(cfg)
    monkeypatch.setattr(oracle, "level_diag", lambda l, stash, nats:
                        _oracle_level_diag(oracle, l, stash, nats))
    monkeypatch.setattr(oracle, "p1_values", lambda stash, nats=None:
                        _oracle_p1_values(oracle, stash, nats))
    made[0] = 0
    ref = oracle.solve()
    assert made[0] == 0
    assert (got.snes_iters, got.ksp_iters) == (ref.snes_iters,
                                               ref.ksp_iters)
    assert torch.equal(got.u, ref.u)
