"""The program's spans and counters (utils/timing): the span tree of a
p-MG + AMG solve and the values read from it, no profiler range without
the profiler, the spans on the profiler's timeline, the bounded store; on
the card (marked `gpu`), a traced solve's idle time named by the spans and
the owner-sum's event time against the profiler's.

Imports no JAX. On the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -q
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import trace as btrace
from ceedpetscsolid_tpu_torch import native
from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem
from ceedpetscsolid_tpu_torch.utils import timing

# the always-on spans of a problem's first p-MG + AMG solve (its first
# Newton step builds the AMG natively, the later ones refresh it on the
# device), and the spans only under the profiler
ALWAYS = {"solve", "newton/step", "newton/residual", "newton/line_search",
          "linear_solve", "pc", "pc/mg/levels", "pc/amg/elem_mats",
          "pc/amg/d2h", "pc/amg/csr", "pc/amg/native", "pc/amg/upload",
          "pc/amg/plan", "pc/amg/galerkin", "pc/amg/lam", "pc/amg/coarse",
          "cg", "cg/iter", "cg/wait"}
FINE = {"vcycle/p2/smooth", "vcycle/p2/restrict", "vcycle/p2/prolong",
        "vcycle/coarse", "op/residual", "op/jv", "op/owner_sum"}


def _problem(device="cpu", box=2, degree=2, multigrid="logarithmic",
             dtype=None):
    return ElasticityProblem(Config(
        problem="hyperFS", degree=degree, test_mode=True,
        box_faces=(box,) * 3, multigrid=multigrid, coarse_solve="amg",
        num_increments=1, device=device, dtype=dtype, ksp_rtol=1e-6))


def _children(spans):
    """{span id: summed duration of its child spans} of a span list."""
    out = {}
    for _, parent, _, t0, t1 in spans:
        if parent is not None:
            out[parent] = out.get(parent, 0) + t1 - t0
    return out


def test_solve_span_tree_and_views():
    """A tiny p-MG + AMG solve: every always-on span and counter, children
    within their parents, and the values read from the spans
    (SolveInfo.pc_time, amg_times, pc_setups) equal to them."""
    prob = _problem()
    info = prob.solve()
    rec = timing.records()[-1]
    sec, counts = rec["seconds"], rec["counts"]
    assert rec["name"] == "solve" and rec["profiled"] is False
    assert rec["spans"] is None and rec["stream_ms"] == {}
    assert ALWAYS <= set(sec)
    assert {"pc/mg/p1/diag", "pc/mg/p1/eig", "pc/mg/p2/diag",
            "pc/mg/p2/eig"} <= set(sec)
    assert not FINE & set(sec)
    assert counts["cg.iterations"] == info.ksp_iters
    assert counts["cg.reads"] == info.ksp_iters + rec["calls"]["cg"]
    assert counts["pc.builds"] == info.snes_iters == prob.pc_setups
    assert counts["amg.device_refreshes"] == info.snes_iters - 1
    assert rec["calls"]["newton/step"] == info.snes_iters
    assert rec["calls"]["cg/iter"] == info.ksp_iters
    # children within their parents
    parts = [k for k in sec if k.startswith(("pc/mg/", "pc/amg/"))]
    assert sum(sec[k] for k in parts) <= sec["pc"]
    assert sec["cg/wait"] <= sec["cg/iter"] <= sec["cg"]
    assert sec["pc"] + sec["cg"] <= sec["linear_solve"]
    assert sec["newton/step"] <= sec["solve"]
    for k, s in sec.items():
        assert 0.0 <= rec["self_seconds"][k] <= s
    # the views
    assert info.solve_time == sec["solve"]
    assert info.pc_time == sec["pc"]
    amg = prob.amg_times
    assert amg["elem_mats"] == sec["pc/amg/elem_mats"]
    assert amg["d2h"] == sec["pc/amg/d2h"]
    assert amg["setup"] == sum(sec[f"pc/amg/{k}"] for k in (
        "csr", "native", "plan", "galerkin", "lam", "coarse"))
    assert amg["upload"] == sec["pc/amg/upload"]
    # the problem's -log_view report holds its stages and the spans
    report = prob.log.report()
    for name in ("SNES Solve", "setup/amg", "pc/amg/native", "cg.iterations"):
        assert name in report


def test_no_profiler_range_without_the_profiler(monkeypatch):
    """Without the profiler no span enters a record_function range, on
    the solve and on a linear solve run on its own (a request of its
    own)."""
    prob = _problem()

    def refuse(*a, **kw):
        raise AssertionError("record_function entered without the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    info = prob.solve()
    assert info.converged
    prob2 = _problem(multigrid="none")
    u = torch.zeros((3, prob2.fine_space.num_nodes), dtype=prob2.dtype)
    G, stash = prob2._nonlinear_residual(u, prob2.bc_values(1.0), prob2.F)
    _, its = prob2._linear_solve(G, stash)
    rec = timing.records()[-1]
    assert rec["name"] == "linear_solve" and not rec["profiled"]
    assert rec["counts"]["cg.iterations"] == its


def test_spans_on_the_profiler_timeline(monkeypatch):
    """Under the CPU profiler every span of a problem's first solve, the
    profiled-only ones too, is a host event inside its parent's; the
    owner-sum's ms are kept; and the trace reduction of the benchmark names
    a host-only gap inside pc/amg/native (the AMG's first, native build) by
    that span."""
    _problem().solve()
    prob = _problem()
    real = native.lib()

    class SlowSetup:
        """The native library, its setup 50 ms slower on the host (no
        torch operation)."""

        def __getattr__(self, name):
            return getattr(real, name)

        def amg_setup(self, *args):
            time.sleep(0.05)
            return real.amg_setup(*args)

    monkeypatch.setattr(native, "lib", SlowSetup)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prob.solve()
    rec = timing.records()[-1]
    assert rec["profiled"] and (ALWAYS | FINE) <= set(rec["seconds"])
    assert rec["stream_ms"]["op/owner_sum"] == pytest.approx(
        1e3 * rec["seconds"]["op/owner_sum"])
    spans = {sid: (parent, name, t0, t1)
             for sid, parent, name, t0, t1 in rec["spans"]}
    kids = _children(rec["spans"])
    for sid, (parent, name, t0, t1) in spans.items():
        assert kids.get(sid, 0) <= t1 - t0
        if parent is not None:
            p0, p1 = spans[parent][2:]
            assert p0 <= t0 and t1 <= p1, name
    # each span name's host events sit inside a host event of a parent
    parents = {}
    for parent, name, _, _ in spans.values():
        if parent is not None:
            parents.setdefault(name, set()).add(spans[parent][1])
    names = set(rec["seconds"])
    seen = set()
    for ev in prof.events():
        if ev.name in parents and ev.name not in seen:
            up = ev.cpu_parent
            while up is not None and up.name not in names:
                up = up.cpu_parent
            assert up is not None and up.name in parents[ev.name], ev.name
            seen.add(ev.name)
    assert FINE <= seen
    # the benchmark's idle-gap reduction: the device busy everywhere but
    # during the last native setup
    host = [(False, e.name(), e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in prof.profiler.kineto_results.events()]
    last = max((h for h in host if h[1] == "pc/amg/native"),
               key=lambda h: h[2])
    t0 = min(h[2] for h in host)
    t1 = max(h[3] for h in host)
    dev = [(True, "kernel", t0, last[2]), (True, "kernel", last[3], t1)]
    out = btrace.reduce_events(host + dev, t0, t1, 1)
    assert out["idle_gaps"][0][0] == "pc/amg/native"
    assert out["idle_gaps"][0][1] >= 0.05


def test_store_stays_bounded():
    """The store keeps the last `cap` records, and a request opened inside
    another adds to its own totals without a record of its own."""
    rec = timing.Recorder(cap=8)
    for i in range(20):
        with rec.request("r") as outer:
            with rec.request("inner") as inner:
                with rec.span("a"):
                    rec.count("n", i)
    kept = rec.records()
    assert len(kept) == 8 and [r["id"] for r in kept] == list(range(12, 20))
    assert {r["name"] for r in kept} == {"r"}
    assert kept[-1]["counts"] == {"n": 19}
    assert outer.record is kept[-1] and inner.record is None
    assert inner.totals.counts == {"n": 19}
    assert set(inner.totals.seconds) == {"a", "inner"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on a GPU")
    return torch.device("cuda")


@pytest.mark.gpu
def test_traced_solve_idle_is_named_on_gpu(cuda):
    """A traced 8^3 p-MG + AMG solve: the idle time the program's spans
    leave unnamed is under 10% of the window; a traced Jacobi CG solve on
    the benchmark's 28^3 box: the owner-sum's CUDA event ms hold the
    profiler's device time of its kernel (csrc/owner_sum.cu, taken by name:
    the profiler attaches no host range to a launch from the kernel
    library), launched once a counted call, and exceed it by no more than
    the device's idle wait before each launch. The start event fires when
    the stream reaches it, so where the stream waits on the host it also
    holds the host's steps to the launch (4.2-8.5 us a call against a
    ~34-us kernel on an H100, so owner_sum_ms.cg reads 12-25% above the
    kernel); a wrong span would add other operations' device time, which
    no idle wait holds. Slack: the events' resolution, 0.5 us below and
    1 us above a call. At 8^3 the host, slower than the kernels, leaves
    the device idle inside the span, and the events count that."""
    prob = _problem(cuda, box=8, degree=4)
    prob.solve()
    tracer = btrace.Tracer(cuda)
    tracer.start()
    prob.solve()
    out = tracer.stop(1)
    unnamed = dict(out["idle_gaps"]).get("host (no operation traced)", 0.0)
    assert unnamed < 0.1 * out["window_s"], out["idle_gaps"]

    prob = _problem(cuda, box=28, degree=4, multigrid="none")
    u = torch.zeros((3, prob.fine_space.num_nodes), dtype=prob.dtype,
                    device=cuda)
    G, stash = prob._nonlinear_residual(u, prob.bc_values(1.0), prob.F)
    prob._linear_solve(G, stash)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        prob._linear_solve(G, stash, refresh=False)
    rec = timing.records()[-1]
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.name not in timing.RECORDER.profiled_names)
    calls, kernel_ms, idle_ms, done = 0, 0.0, 0.0, None
    for t0, t1, name in ops:
        if "cps_restr::csr_gather_sum" in name:
            calls += 1
            kernel_ms += 1e-3 * (t1 - t0)
            if done is not None:
                idle_ms += 1e-3 * max(t0 - done, 0)
        done = t1 if done is None else max(done, t1)
    assert calls == rec["counts"]["restr.owner_sum_kernel"] > 0
    ev = rec["stream_ms"]["op/owner_sum"]
    assert kernel_ms - 0.5e-3 * calls <= ev
    assert ev <= kernel_ms + idle_ms + 1e-3 * calls
