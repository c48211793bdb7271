"""Phase-scoped timing and the program's spans (the PetscLogStage and
PetscLogEvent analogs; reference elasticity.c:128-131, 230-233, 381-384,
627-630 register the stages "DM and Vector Setup", "libCEED Setup",
"SNES Setup", "SNES Solve", surfaced by -log_view).

A span times one pass through a layer boundary: its name carries the
layer path ("pc/amg/native"), its start and end are
time.perf_counter_ns() readings, and it nests in the span open around it.
A request (`request`) is the outermost unit of work: a solve, or a linear
solve called on its own. The spans and counters (`count`) inside it add
up into its record, and the process-wide store (`RECORDER`, read by
`records()`) keeps the records of the last CAP requests: the request's
name, whether it ran under the profiler, seconds, self seconds (less the
child spans) and calls by span name, counts by counter, device ms by span
name where a span asks for them, and, for a profiled request only, its
spans with their ids and parents. The store outlives the problem that
made the records.

Two tiers, decided when a request opens by reading
torch.autograd._profiler_enabled() once (outside a request, at each span):
  span(name)   always on: two clock readings and no device
               synchronisation (a stage asks for one, `sync`);
  fine(name)   only under the profiler; without it, one flag test.
Under the profiler every span is also a torch.profiler.record_function
range, entered and left at its clock readings, so the trace's host
timeline carries the program's layer names and names the device's idle
gaps. fine(name, stream=device) on a CUDA device also records a CUDA event
pair around the span, read when the request closes (it has synchronised
by then): the device ms of the work enqueued inside it. On the CPU the
span's host ms stand in, since the work there is synchronous.

Each ElasticityProblem and each DistributedProblem owns a StageLog on its
device (which has no default: a log that forgot it would time nothing on
the card). A stage is a span that synchronises the device before its end
reading, so its time includes the work it queued; the log adds up its
stages and every span that closes inside one (count, total and self
seconds) for the -log_view report. `cuda_time_ms` times one call on the
card with CUDA events (kernel and operator timings), the host's enqueue
included; `cuda_device_ms` times the device's work alone.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import time
from dataclasses import dataclass, field

import torch


def sync(device: torch.device) -> None:
    """Wait for queued work on `device` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _sleep_ms_per_mcycle() -> float:
    """Device time of torch.cuda._sleep(10**6), in ms."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10**6)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def cuda_device_ms(fn, reps: int = 20, inner: int = 10,
                   warmup: int = 3) -> float:
    """Median device time of one fn() in ms, without the host's enqueue.

    Each sample brackets `inner` calls with CUDA events, enqueued behind a
    torch.cuda._sleep that holds the stream until the host has enqueued
    them all, so the events see only the device's work (and the gaps the
    device itself leaves between kernels). The sleep starts at four times
    the measured enqueue time plus 1 ms; a sample whose enqueue outlasted
    it (a host stall) is dropped and the sleep doubled, at most 8 times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int((4 * enqueue_ms + 1.0) / _sleep_ms_per_mcycle() * 1e6)
    ts, stalls = [], 0
    while len(ts) < reps:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if s.elapsed_time(a) > host_ms:
            ts.append(a.elapsed_time(b) / inner)
            continue
        stalls += 1
        if stalls > 8:
            raise RuntimeError(
                f"cuda_device_ms: the enqueue ({host_ms:.3f} ms) outlasted "
                f"the stream-holding sleep ({s.elapsed_time(a):.3f} ms) "
                f"{stalls} times")
        cycles *= 2
    return statistics.median(ts)




# requests the store keeps
CAP = 4096
_ns = time.perf_counter_ns
_profiler_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class Totals:
    """What a request or a StageLog adds up: by span name [seconds, self
    seconds, calls] (`spans`), counts by counter, device ms by span name;
    `seconds`, `self_seconds` and `calls` read them by span name."""

    __slots__ = ("spans", "counts", "stream_ms")

    def __init__(self):
        self.spans, self.counts, self.stream_ms = {}, {}, {}

    def count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def add_ms(self, name: str, ms: float) -> None:
        self.stream_ms[name] = self.stream_ms.get(name, 0.0) + ms

    @property
    def seconds(self) -> dict:
        return {k: e[0] for k, e in self.spans.items()}

    @property
    def self_seconds(self) -> dict:
        return {k: e[1] for k, e in self.spans.items()}

    @property
    def calls(self) -> dict:
        return {k: e[2] for k, e in self.spans.items()}


class Span:
    """One pass through a layer boundary, as a context manager; after it
    closes, `seconds` is its duration and, for the outermost request,
    `record` its record (else None). A request's `totals` hold what its
    spans and counters added up, whether or not it was the outermost. A
    span that is not a request may be entered again once it has closed
    (a loop's body reuses one)."""

    __slots__ = ("name", "seconds", "record", "totals", "_rec", "_sync",
                 "_stream", "_log", "_pushed", "_t0", "_child", "_rf",
                 "_ev", "_id", "_parent")

    def __init__(self, rec: "Recorder", name: str, sync=None, stream=None,
                 log: "StageLog | None" = None, totals=None):
        self.name = name
        self._rec = rec
        self._sync = sync
        self._stream = stream
        self._log = log
        self.totals = totals
        self.seconds = self.record = None
        self._rf = self._ev = self._id = None

    def __enter__(self):
        rec = self._rec
        if self.totals is not None or self._log is not None:
            self._open(rec)
        prof = rec.profiled
        if prof or (prof is None and _profiler_enabled()):
            self._profile(rec)
        self._child = 0
        rec._stack.append(self)
        self._t0 = _ns()
        return self

    def _open(self, rec: "Recorder") -> None:
        if self.totals is not None:
            rec._open_request(self)
        log = self._log
        self._pushed = (log is not None
                        and not any(a is log.spans for a in rec._accs))
        if self._pushed:
            rec._accs.append(log.spans)

    def _profile(self, rec: "Recorder") -> None:
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        rec.profiled_names.add(self.name)
        if rec._req is not None:
            self._id = rec._next_span
            rec._next_span += 1
            self._parent = rec._stack[-1]._id if rec._stack else None
            if self._stream is not None and self._stream.type == "cuda":
                self._ev = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                self._ev[0].record()

    def __exit__(self, *exc):
        rec = self._rec
        if self._sync is not None:
            sync(self._sync)
        if self._ev is not None:
            self._ev[1].record()
        t1 = _ns()
        stack = rec._stack
        stack.pop()
        dur = t1 - self._t0
        if stack:
            stack[-1]._child += dur
        self.seconds = secs = dur * 1e-9
        self_s = (dur - self._child) * 1e-9
        name = self.name
        for acc in rec._accs:
            e = acc.spans.get(name)
            if e is None:
                acc.spans[name] = [secs, self_s, 1]
            else:
                e[0] += secs
                e[1] += self_s
                e[2] += 1
        if self._rf is not None:
            self._unprofile(rec, t1)
        if self._log is not None:
            self._log.add(name, secs)
            if self._pushed:
                rec._accs.pop()
        if self.totals is not None:
            rec._close_request(self)
        return False

    def _unprofile(self, rec: "Recorder", t1: int) -> None:
        self._rf.__exit__(None, None, None)
        if self._id is not None:
            rec._spans.append((self._id, self._parent, self.name, self._t0,
                               t1))
        if self._ev is not None:
            rec._events.append((self.name, *self._ev))
        elif self._stream is not None:
            for acc in rec._accs:
                acc.add_ms(self.name, self.seconds * 1e3)
        self._rf = self._ev = self._id = None


class Recorder:
    """The process-wide store of spans, counters and request records (see
    the module's docstring); `RECORDER` is the one the program uses."""

    def __init__(self, cap: int = CAP):
        self._records = collections.deque(maxlen=cap)
        self._stack = []        # open spans, innermost last
        self._accs = []         # open Totals: requests' and stage logs'
        self._req = None        # the open outermost request
        self._spans = self._events = None
        self._next_span = self._next_request = 0
        # the profiler tier of the open request (None: no request open)
        self.profiled = None
        # every name entered as a record_function range in this process
        self.profiled_names = set()

    def span(self, name: str, sync=None, log=None) -> Span:
        """An always-on span; sync: a device to synchronise before its end
        reading (no-op on the CPU)."""
        return Span(self, name, sync, None, log)

    def fine(self, name: str, stream=None):
        """A span only under the profiler (a no-op context otherwise);
        stream: the device of the work inside, whose ms it records."""
        p = self.profiled
        if p is False or (p is None and not _profiler_enabled()):
            return _NULL
        return Span(self, name, None, stream)

    def request(self, name: str) -> Span:
        """A span that opens a request when none is open (else a span with
        totals of its own)."""
        return Span(self, name, totals=Totals())

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter `name` of every open request and log."""
        for acc in self._accs:
            acc.count(name, n)

    def add_ms(self, name: str, ms: float) -> None:
        """Add device ms that the caller timed itself (CUDA events) under
        the span name `name`, in every open request and log."""
        for acc in self._accs:
            acc.add_ms(name, ms)

    def records(self) -> list:
        """The kept request records, oldest first."""
        return list(self._records)

    def _open_request(self, span: Span) -> None:
        if self._req is None:
            self._req = span
            self.profiled = _profiler_enabled()
            self._spans, self._events = [], []
        self._accs.append(span.totals)

    def _close_request(self, span: Span) -> None:
        self._accs.pop()
        if self._req is not span:
            return
        t = span.totals
        if self._events:
            # under the profiler: a range of its own on the trace
            with torch.profiler.record_function("timing/stream_ms"):
                self._events[-1][2].synchronize()
                for name, a, b in self._events:
                    t.add_ms(name, a.elapsed_time(b))
        rec = {"id": self._next_request, "name": span.name,
               "profiled": self.profiled, "seconds": t.seconds,
               "self_seconds": t.self_seconds, "calls": t.calls,
               "counts": t.counts, "stream_ms": t.stream_ms,
               "spans": self._spans if self.profiled else None}
        self._next_request += 1
        self._records.append(rec)
        span.record = rec
        self._req = self._spans = self._events = None
        self.profiled = None


RECORDER = Recorder()
span = RECORDER.span
fine = RECORDER.fine
request = RECORDER.request
count = RECORDER.count
add_ms = RECORDER.add_ms
records = RECORDER.records


@dataclass
class StageLog:
    """Accumulating named phase timers on `device`, and the totals of the
    spans and counters inside its stages (`spans`)."""

    device: torch.device
    stages: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)
    spans: Totals = field(default_factory=Totals)

    def stage(self, name: str) -> Span:
        """A span under `name` that synchronises the device before its end
        reading; its seconds count as one more call of the stage."""
        return RECORDER.span(name, sync=self.device, log=self)

    def add(self, name: str, seconds: float) -> None:
        """Count `seconds` under `name`, as one more call of the stage."""
        if name not in self.stages:
            self.stages[name] = [0.0, 0]
            self._order.append(name)
        self.stages[name][0] += seconds
        self.stages[name][1] += 1

    def seconds(self) -> dict:
        """{stage: seconds so far}, in the order the stages first ran."""
        return {name: self.stages[name][0] for name in self._order}

    def report(self) -> str:
        """-log_view style summary: the stages, then every span inside
        them (count, total and self seconds) and the counters."""
        lines = ["Stage                          Time (s)   Count"]
        for name in self._order:
            t, c = self.stages[name]
            lines.append(f"{name:30s} {t:9.4f}   {c:5d}")
        sp = self.spans
        if sp.spans:
            lines += ["", "Span                             Count   Total (s)"
                      "    Self (s)"]
            for name, (t, s, c) in sorted(sp.spans.items()):
                lines.append(f"{name:30s} {c:7d} {t:11.4f} {s:11.4f}")
        if sp.counts:
            lines += ["", "Counter                          Count"]
            lines += [f"{name:30s} {n:7d}"
                      for name, n in sorted(sp.counts.items())]
        return "\n".join(lines)
