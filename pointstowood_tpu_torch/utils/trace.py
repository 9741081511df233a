"""The port's tracer: spans and counters placed at its layer boundaries.

    from pointstowood_tpu_torch.utils import trace

    with trace.span("model.forward"):          # a span (off: a flag check)
        ...
    trace.count("batch.points", n)             # a counter
    with trace.span("step.update", marks=dev): # + device marks at its ends
        ...
    with trace.timed(seconds, "model"):        # a phase: always timed into
        ...                                    # seconds["model"]
    torch.cuda.synchronize()
    rec = trace.collected()                    # spans, counters, marks

Tracing is off by default. It is on

* for the whole of a ``session()``: the predict CLI's ``--profile DIR``
  opens one (``cli/predict.py``), or
* while an entry point runs (``entry()``: ``cli.predict.main``,
  ``semantic_segmentation``, ``run_inference``, the train step,
  ``trainer._batch_arrays``, ``TileBatcher`` iteration,
  ``semantic_training``) called from a thread in which a
  ``torch.profiler`` session records.

While it is on, spans and counters are recorded in every thread, so the
work an entry point hands to a worker thread (the CLI's ingest and write
thread, the fusion plan's thread) is traced too, though the profiler
does not see those threads. Off, ``span`` and ``count`` cost one flag
check: no clock read, no ``record_function``, no CUDA event. ``timed``
phases, whose seconds the CLI returns, read the clock either way.

A span records its name, thread, start and end (``perf_counter_ns``),
its parent span and the request it serves (a plot's index in the CLI
call, a train step's number), inherited from its parent unless given.
On a thread in which the profiler records, a span also opens a
``record_function`` range of its name. Each time tracing turns on under
a profiler, the tracer opens one anchor range and keeps its
``perf_counter_ns`` reading beside the Unix clock's; ``resolve(events)``
reads the anchors' ranges from the profiler's events, which puts every
span, from any thread, on the trace's clock: the profiler stamps on the
Unix clock, and an anchor's range bounds how far the two may part (the
Unix clock alone stands in for an anchor not resolved).

Device marks (``marks=device``) are CUDA events recorded on the current
stream at a span's start and end (the host clock stands in on the CPU).
They are read only in ``collected()``, after the caller has
synchronised: tracing adds no synchronisation to any path.

A CUDA graph replays kernels without the Python that launched them, so
the spans with device marks inside one are recorded while it is
captured, under a ``GraphMarks`` object's ``recording()``: each end
launches a stamp kernel (``csrc/stamp.cu``) that writes the device's
clock into a slot of the object's buffer. After each replay while
tracing is on, ``replayed()`` copies the buffer, and the counters'
tensors, in stream order, and adds the capture's spans and counts to
the tracer as that replay's.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import re
import threading
import time

import torch
from torch.autograd.profiler import record_function

ANCHOR = "pointstowood::anchor"


class _Null:
    """What ``span`` returns with tracing off: one shared, empty context."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session records in this thread."""
    return torch.autograd._profiler_enabled()


class Tracer:
    """Spans, counters and anchors of one process (the module's
    ``TRACER``); ``reset()`` clears them."""

    def __init__(self):
        self.on = False
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        self.spans = []    # closed spans (dicts), in closing order
        self.counts = []   # (name, n or a tensor, perf ns, thread, request)
        self.anchors = []  # [name, perf ns, unix ns, trace ns or None]

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def anchor(self) -> None:
        """Open one anchor range (a no-op unless the profiler records in
        this thread): its name is unique, so ``resolve`` finds it."""
        if not _profiling():
            return
        name = f"{ANCHOR}/{next(self._ids)}"
        with record_function(name):
            p0 = time.perf_counter_ns()
            unix = time.time_ns()
            p1 = time.perf_counter_ns()
        self.anchors.append([name, (p0 + p1) // 2, unix, None])

    def resolve(self, events) -> int:
        """Read the anchors' times on the trace's clock from a profiler's
        events (``prof.profiler.kineto_results.events()``); returns how
        many were found. An anchor's range, on the trace's clock,
        brackets its clock reads; the Unix clock's reading (the clock the
        profiler converts its stamps to) places them inside the bracket,
        and is held to it where the two clocks part."""
        want = {a[0]: a for a in self.anchors if a[3] is None}
        found = 0
        for e in events:
            a = want.get(e.name())
            if a is None:
                continue
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            a[3] = min(max(a[2], start), end)
            found += 1
        return found

    def offset(self, perf_ns: int) -> int:
        """Trace clock minus ``perf_counter_ns`` near ``perf_ns``: the
        nearest resolved anchor's, else the nearest anchor's Unix-clock
        reading, else the Unix clock now."""
        resolved = [a for a in self.anchors if a[3] is not None]
        pool = resolved or self.anchors
        if not pool:
            return time.time_ns() - time.perf_counter_ns()
        a = min(pool, key=lambda a: abs(a[1] - perf_ns))
        return (a[3] if a[3] is not None else a[2]) - a[1]

    def collected(self) -> dict:
        """The spans, counters and resolved marks recorded since
        ``reset()``. Each span: ``id``, ``name``, ``thread``, ``parent``,
        ``request``, ``attrs``, ``start_ns`` / ``end_ns``
        (``perf_counter_ns``), ``trace_start_ns`` / ``trace_end_ns`` (the
        profiler's clock), and ``device_ms``: its marks' (start, end) in
        ms from the first mark of the collection, or None. Call after
        synchronising the device."""
        spans = sorted(self.spans, key=lambda s: s["start_ns"])
        marked = [s for s in spans if s["marks"] is not None]
        origin = marked[0]["marks"][0] if marked else None
        stamps: dict = {}  # a replay's copy of its stamps, read once
        out = []
        for s in spans:
            off = self.offset(s["start_ns"])
            rec = {k: v for k, v in s.items() if k != "marks"}
            rec["trace_start_ns"] = s["start_ns"] + off
            rec["trace_end_ns"] = s["end_ns"] + off
            rec["device_ms"] = (None if s["marks"] is None else tuple(
                _elapsed_ms(origin, m, stamps) for m in s["marks"]))
            out.append(rec)
        counts = [(name, int(n), *rest) for name, n, *rest in self.counts]
        totals: dict = {}
        for name, n, *_ in counts:
            totals[name] = totals.get(name, 0) + n
        return {"spans": out, "counters": totals,
                "counts": counts,
                "anchors": [tuple(a) for a in self.anchors]}


def _elapsed_ms(origin, mark, stamps: dict) -> float:
    o_event, o_ms = _event_ms(origin, stamps)
    m_event, m_ms = _event_ms(mark, stamps)
    if isinstance(m_event, int):  # the host clock's stand-in
        return (m_event - o_event) * 1e-6 + m_ms - o_ms
    return o_event.elapsed_time(m_event) + m_ms - o_ms


def _event_ms(mark, stamps: dict):
    """A mark as (a CUDA event, ms after it): a replayed span's mark is
    (the event before its replay, the replay's copy of the stamps, its
    slot), ms after the replay's first stamp (slot 0)."""
    if not isinstance(mark, tuple):
        return mark, 0.0
    event, copy, slot = mark
    ns = stamps.get(id(copy))
    if ns is None:
        ns = stamps[id(copy)] = copy.tolist()
    return event, (ns[slot] - ns[0]) * 1e-6


def _stamp(buf: torch.Tensor, slot: int) -> None:
    """The device's clock (ns) into ``buf[slot]``: the stamp kernel on a
    CUDA tensor, ``perf_counter_ns`` on the CPU."""
    if buf.device.type == "cpu":
        buf[slot] = time.perf_counter_ns()
        return
    from pointstowood_tpu_torch.ops import build

    stream = torch.cuda.current_stream(buf.device).cuda_stream
    build.check(build.library("stamp").ptw_stamp(buf.data_ptr(), slot,
                                                 stream), "stamp")


def _mark(device):
    if device is not None and torch.device(device).type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter_ns()


class _Span:
    __slots__ = ("tracer", "name", "parent", "request", "marks", "attrs",
                 "id", "t0", "m0", "rf")

    def __init__(self, tracer, name, parent, request, marks, attrs):
        self.tracer = tracer
        self.name = name
        self.parent = parent
        self.request = request
        self.marks = marks
        self.attrs = attrs

    def __enter__(self):
        t = self.tracer
        st = t.stack()
        up = self.parent if self.parent is not None else (
            st[-1] if st else None)
        self.parent = up[0] if up else None
        if self.request is None and up:
            self.request = up[1]
        self.id = next(t._ids)
        st.append((self.id, self.request))
        self.rf = None
        if _profiling():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.m0 = _mark(self.marks) if self.marks is not None else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        m1 = _mark(self.marks) if self.marks is not None else None
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t = self.tracer
        t.stack().pop()
        t.spans.append({
            "id": self.id, "name": self.name,
            "thread": threading.current_thread().name,
            "parent": self.parent, "request": self.request,
            "attrs": self.attrs, "start_ns": self.t0, "end_ns": t1,
            "marks": None if m1 is None else (self.m0, m1)})
        return False


class _Timed:
    """A phase: its seconds go into ``seconds[key]`` whether tracing is on
    or off; on, it is also the span ``name``."""

    __slots__ = ("seconds", "key", "span", "t0")

    def __init__(self, seconds, key, span):
        self.seconds = seconds
        self.key = key
        self.span = span

    def __enter__(self):
        self.span.__enter__()
        if self.seconds is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.seconds is not None:
            self.seconds[self.key] = time.perf_counter() - self.t0
        return self.span.__exit__(*exc)


class _On:
    """Tracing on until exit (``session``, ``entry``)."""

    __slots__ = ("tracer", "clear", "was")

    def __init__(self, tracer, clear):
        self.tracer = tracer
        self.clear = clear

    def __enter__(self):
        if self.clear:
            self.tracer.reset()
        self.was = self.tracer.on
        self.tracer.on = True
        self.tracer.anchor()
        return self.tracer

    def __exit__(self, *exc):
        self.tracer.on = self.was
        return False


TRACER = Tracer()
_RECORDING = None  # the GraphMarks recording a capture, or None


class GraphMarks:
    """The spans with device marks and the counters of a CUDA graph, for
    a traced replay (see the module docstring). ``slots``: stamps the
    buffer holds (two a span and the first)."""

    def __init__(self, device, slots: int = 256):
        self.buf = torch.zeros(slots, dtype=torch.int64, device=device)
        self.thread = None
        self.spans = []   # (name, slot at its start, slot at its end)
        self.counts = []  # (name, a tensor or an int)
        self.used = 1     # slot 0: the first stamp of a pass

    @contextlib.contextmanager
    def recording(self):
        """One pass of the captured code (a capture's warm-up passes run
        it too; the last pass's spans are kept): spans with device marks
        stamp their ends, counters keep their values, tracing off."""
        global _RECORDING
        self.spans, self.counts, self.used = [], [], 1
        self.thread = threading.get_ident()
        _stamp(self.buf, 0)
        _RECORDING = self
        try:
            yield self
        finally:
            _RECORDING = None

    def _slot(self) -> int:
        if self.used == self.buf.numel():
            raise RuntimeError(f"GraphMarks: more than {self.used} stamps")
        _stamp(self.buf, self.used)
        self.used += 1
        return self.used - 1

    @contextlib.contextmanager
    def _span(self, name: str):
        s0 = self._slot()
        try:
            yield None
        finally:
            self.spans.append((name, s0, self._slot()))

    def before(self):
        """Call just before a replay: (a CUDA event, ``perf_counter_ns``)
        while tracing is on, else None."""
        if not TRACER.on:
            return None
        return _mark(self.buf.device), time.perf_counter_ns()

    def replayed(self, before) -> None:
        """Call just after the replay that ``before`` preceded: the
        capture's spans and counts as this replay's, children of this
        thread's open span."""
        if before is None or not TRACER.on:
            return
        event, t0 = before
        copy = self.buf[:self.used].clone()
        t1 = time.perf_counter_ns()
        st = TRACER.stack()
        parent, request = st[-1] if st else (None, None)
        thread = threading.current_thread().name
        for name, s0, s1 in self.spans:
            TRACER.spans.append({
                "id": next(TRACER._ids), "name": name, "thread": thread,
                "parent": parent, "request": request,
                "attrs": {"replayed": True}, "start_ns": t0, "end_ns": t1,
                "marks": ((event, copy, s0), (event, copy, s1))})
        for name, n in self.counts:
            n = n.detach().clone() if isinstance(n, torch.Tensor) else n
            TRACER.counts.append((name, n, t1, thread, request))


def _recording():
    """The GraphMarks recording in this thread, or None."""
    rec = _RECORDING
    return rec if rec is not None and rec.thread == threading.get_ident() \
        else None


def span(name: str, parent=None, request=None, marks=None, **attrs):
    """A span of ``name`` while tracing is on (a shared empty context
    while it is off). ``parent``: ``current()`` of the thread that handed
    this work over (default: this thread's open span); ``request``: the
    plot or step served (default: the parent's); ``marks``: the device
    whose current stream takes a CUDA event at each end; ``attrs``: kept
    with the span. Off, a span with marks inside a ``GraphMarks``
    recording stamps its ends instead."""
    if not TRACER.on:
        if _RECORDING is None or marks is None:
            return NULL
        rec = _recording()
        return NULL if rec is None else rec._span(name)
    return _Span(TRACER, name, parent, request, marks, attrs)


def timed(seconds: dict | None, key: str, name: str | None = None,
          **kwargs):
    """A phase: ``seconds[key]`` receives its wall seconds (host clock)
    whether tracing is on or off, and, on, it is the span ``name``
    (default ``key``; ``kwargs`` as ``span``'s). ``seconds=None`` times
    nothing; ``span`` alone then."""
    return _Timed(seconds, key, span(name or key, **kwargs))


def active() -> bool:
    """Whether tracing is on, or a ``GraphMarks`` records in this thread
    (for work done only to feed a counter)."""
    return TRACER.on or (_RECORDING is not None and _recording() is not None)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on (inside a
    ``GraphMarks`` recording: to each traced replay's counts). A device
    tensor is kept as it is and read only in ``collected()``, so a count
    computed on the device adds no synchronisation."""
    if not TRACER.on:
        rec = _recording() if _RECORDING is not None else None
        if rec is not None:
            rec.counts.append((name, n))
        return
    st = TRACER.stack()
    n = n.detach() if isinstance(n, torch.Tensor) else int(n)
    TRACER.counts.append((name, n, time.perf_counter_ns(),
                          threading.current_thread().name,
                          st[-1][1] if st else None))


def current():
    """This thread's open span as a ``parent`` for work handed to another
    thread (None while tracing is off or no span is open)."""
    if not TRACER.on:
        return None
    st = TRACER.stack()
    return st[-1] if st else None


def entry():
    """Wrap an entry point: tracing on while it runs when a profiler
    records in this thread (and tracing is not on already); else a flag
    check and the profiler's."""
    if TRACER.on or not _profiling():
        return NULL
    return _On(TRACER, clear=False)


def entry_point(fn):
    """Decorate an entry point: ``fn`` runs inside ``entry()``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with entry():
            return fn(*args, **kwargs)

    return wrapper


def session():
    """Tracing on, cleared at the start, for the whole ``with`` block."""
    return _On(TRACER, clear=True)


def anchor() -> None:
    TRACER.anchor()


def resolve(events) -> int:
    return TRACER.resolve(events)


def collected() -> dict:
    return TRACER.collected()


def reset() -> None:
    TRACER.reset()


def chrome_events(rec: dict | None = None, base_ns: int = 0) -> list:
    """Chrome-trace events of ``collected()``'s spans and counters, on the
    profiler's clock (microseconds from ``base_ns``, as
    ``export_chrome_trace`` writes them): one row a thread, a counter as
    its running total."""
    rec = collected() if rec is None else rec
    out = []
    for s in rec["spans"]:
        args = dict(s["attrs"], id=s["id"], parent=s["parent"],
                    request=s["request"])
        if s["device_ms"] is not None:
            args["device_ms"] = list(s["device_ms"])
        out.append({"name": s["name"], "ph": "X", "pid": "program",
                    "tid": s["thread"],
                    "ts": (s["trace_start_ns"] - base_ns) / 1e3,
                    "dur": (s["trace_end_ns"] - s["trace_start_ns"]) / 1e3,
                    "args": args})
    totals: dict = {}
    for name, n, t_ns, thread, request in rec["counts"]:
        totals[name] = totals.get(name, 0) + n
        out.append({"name": name, "ph": "C", "pid": "program", "tid": thread,
                    "ts": (t_ns + TRACER.offset(t_ns) - base_ns) / 1e3,
                    "args": {name: totals[name]}})
    return out


def write_chrome(path: str, beside: str | None = None) -> None:
    """``chrome_events()`` as a Chrome-trace JSON file, on the time base
    of the ``torch.profiler`` trace ``beside`` (its header's
    ``baseTimeNanoseconds``) where that file exists, so the two line up."""
    base = 0
    if beside is not None and os.path.exists(beside):
        with open(beside) as f:
            found = re.search(r'"baseTimeNanoseconds":\s*(\d+)',
                              f.read(1 << 16))
        base = int(found[1]) if found else 0
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base,
                   "traceEvents": chrome_events(base_ns=base)}, f)
