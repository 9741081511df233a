"""The traced window of a ``--trace 1`` run: ``torch.profiler`` with CPU
and CUDA activity over a part of the measured window, and its reduction
to the device's busy time, its idle gaps and its kernel times.

Host spans are the benchmark's own (``span``), opened around its calls
into the program's layers in any thread; an idle gap of the device is
labelled by the innermost host span open at its midpoint.

An operation span (``operation``, around one call of the program that
does one operation of the roofline) times that call's device work whole,
between two CUDA events on the stream: its kernels and the gaps between
them; kernels outside such spans are counted by their names.
"""

from __future__ import annotations

import contextlib
import re
import time

WINDOW = "portbench::window"
PREFIX = "portbench::"
SHORT_GAP_NS = 20_000
SHORT = "gaps under 20 us (launch overhead)"
NAME_CHARS = 160  # of a device operation's name in the breakdown


class Tracer:
    """Collects one traced window. ``span(name)`` marks host activity in
    any thread (a no-op when tracing is off); spans are kept on the host's
    monotonic clock and placed on the trace's through the window's own
    span."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.events = None
        self.spans = []
        self.ops = []
        self.opened_ns = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.perf_counter_ns(), name))

    @contextlib.contextmanager
    def operation(self, op: str):
        """Time the device work launched inside as ``op``'s (host time
        where there is no CUDA device; a no-op when tracing is off)."""
        if not self.active:
            yield
            return
        import torch

        if torch.cuda.is_available():
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
            yield
            marks[1].record()
        else:
            marks = [time.perf_counter()]
            yield
            marks.append(time.perf_counter())
        self.ops.append((op, *marks))

    def op_seconds(self) -> dict:
        """Seconds by operation of the spans, once the window has ended."""
        out = {}
        for op, a, b in self.ops:
            s = b - a if isinstance(a, float) else a.elapsed_time(b) * 1e-3
            out[op] = out.get(op, 0.0) + s
        return out

    @contextlib.contextmanager
    def window(self):
        if not self.enabled or self.events is not None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.start()
        self.active = True
        try:
            with record_function(WINDOW):
                self.opened_ns = time.perf_counter_ns()
                yield
                if cuda:
                    torch.cuda.synchronize()
        finally:
            self.active = False
            prof.stop()
        self.events = list(prof.profiler.kineto_results.events())

    def summary(self) -> dict | None:
        if self.events is None:
            return None
        return dict(reduce(self.events, self.spans, self.opened_ns),
                    op_s=self.op_seconds(), op_spans=len(self.ops))


def _is_device(e) -> bool:
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    kind = getattr(e, "activity_type", lambda: "")()
    return ("CUDA" in str(e.device_type()) and not annotation
            and not e.name().startswith(PREFIX)
            and "annotation" not in str(kind).lower())


def kernel_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()


def reduce(events, host_spans=(), opened_ns=None) -> dict:
    """busy_s and window_s of the traced window, seconds by kernel name,
    the ten longest device operations' totals and the idle time by the
    host span open across each gap."""
    win = [e for e in events if e.name() == WINDOW and "CPU" in str(
        e.device_type())]
    if not win:
        raise RuntimeError("the traced window has no span")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    dev = sorted((max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(),
                                             w1), e.name())
                 for e in events if _is_device(e))
    dev = [d for d in dev if d[1] > d[0]]
    by_name: dict = {}
    for s, t, name in dev:
        key = kernel_name(name)
        by_name[key] = by_name.get(key, 0.0) + (t - s) * 1e-9
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-9
    gaps, edge = [], w0
    for s, t in merged + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    shift = w0 - (opened_ns if opened_ns is not None else w0)
    spans = [(a + shift, b + shift, name) for a, b, name in host_spans]
    idle: dict = {}
    for s, t in gaps:
        if t - s < SHORT_GAP_NS:
            idle[SHORT] = idle.get(SHORT, 0.0) + (t - s) * 1e-9
            continue
        mid = (s + t) / 2
        open_ = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = (min(open_, key=lambda sp: sp[1] - sp[0])[2] if open_
                 else "outside the benchmark's spans")
        idle[label] = idle.get(label, 0.0) + (t - s) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": (w1 - w0) * 1e-9,
            "kernel_s": by_name,
            "breakdown": {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in gaps_top]}}
