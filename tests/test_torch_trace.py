"""The port's tracer (``pointstowood_tpu_torch.utils.trace``) on the CPU:
off by default, recording nothing; on under a ``torch.profiler`` session
around ``cli.predict.main``, with the ingest and write thread's spans
placed on the profiler's clock through the anchor; the index fusion's
host-searched rows counted as the CLI prints them; the train step's four
spans with host-clock marks; the CLI's phase seconds unchanged."""

import json
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointstowood_tpu_torch.cli import predict as cli
from pointstowood_tpu_torch.config import ModelConfig, TrainConfig
from pointstowood_tpu_torch.io import write_ply
from pointstowood_tpu_torch.predict.predicter import build_net
from pointstowood_tpu_torch.train.trainer import (
    make_optimizer,
    make_train_step,
)
from pointstowood_tpu_torch.utils import trace

FLAGS = ["--channels", "8", "--min_pts", "64", "--max_pts", "1024",
         "--batch_size", "2"]
PAIR_KEYS = {"read", "preprocess", "model", "fusion_plan", "fusion_wait",
             "fusion", "write"}
INDEX_KEYS = {"read", "preprocess", "model", "fusion_wait", "fusion_index",
              "fusion", "write"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plot(path, seed, n=600, loose=0):
    """A 4 m x 4 m plot, 2 m high (one 4 m cell, four 2 m cells), and
    ``loose`` rows in a 4 m cell of their own that min_pts drops (rows no
    tile covers)."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(0, 4, (n, 2)),
                          rng.uniform(0, 2, (n, 1))], 1)
    far = np.concatenate([rng.uniform(5, 7, (loose, 2)),
                          rng.uniform(0, 2, (loose, 1))], 1)
    xyz = np.concatenate([xyz, far])
    write_ply(str(path), {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                          "scalar_Refl": rng.normal(0, 1, len(xyz))})
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    torch.manual_seed(0)
    net = build_net(ModelConfig(channels=8), device="cpu")
    model = str(d / "model.pth")
    torch.save({"model_state_dict": net.state_dict()}, model)
    return {"dir": d, "model": model,
            "plots": [_plot(d / f"p{i}.ply", i) for i in range(2)],
            "loose": _plot(d / "loose.ply", 5, loose=40)}


@pytest.fixture(scope="module")
def traced(files):
    """Two plots through the CLI under a CPU profiler: the tracer's
    record, placed on the profiler's clock, and the profiler's events."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        records = cli.main(["--point-cloud", *files["plots"], "--model",
                            files["model"]] + FLAGS, device="cpu")
    events = list(prof.profiler.kineto_results.events())
    assert trace.resolve(events) >= 1
    rec = trace.collected()
    trace.reset()
    return {"records": records, "rec": rec, "events": events}


def test_off_records_nothing_and_opens_no_range(files, monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(trace, "record_function", no_range)
    trace.reset()
    assert trace.span("x") is trace.NULL and not trace.active()
    (rec,) = cli.main(["--point-cloud", files["plots"][0], "--model",
                       files["model"]] + FLAGS, device="cpu")
    got = trace.collected()
    assert got["spans"] == [] and got["counters"] == {}
    assert got["anchors"] == []
    assert set(rec["seconds"]) == PAIR_KEYS


def test_phase_seconds_keep_their_keys(traced):
    for r in traced["records"]:
        assert set(r["seconds"]) == PAIR_KEYS
        assert all(v >= 0 for v in r["seconds"].values())


def test_phase_seconds_are_the_spans(traced):
    """The CLI's seconds and the spans of those phases are one timing."""
    spans = traced["rec"]["spans"]
    for plot, r in enumerate(traced["records"]):
        for key, name in (("read", "ingest.read"), ("model", "model"),
                          ("write", "write")):
            (s,) = [s for s in spans if s["name"] == name
                    and s["request"] == plot]
            assert abs((s["end_ns"] - s["start_ns"]) * 1e-9
                       - r["seconds"][key]) < 1e-3


def test_worker_spans_carry_thread_plot_and_parent(traced):
    spans = traced["rec"]["spans"]
    by_id = {s["id"]: s for s in spans}
    (call,) = [s for s in spans if s["name"] == "predict"]
    assert call["thread"] == "MainThread"
    for name in ("ingest", "ingest.read", "preprocess", "ingest.cells",
                 "write", "fusion_plan"):
        found = [s for s in spans if s["name"] == name]
        assert {s["request"] for s in found} == {0, 1}, name
        for s in found:
            assert s["thread"] != "MainThread", name
            assert s["parent"] in by_id, name
    for s in spans:
        if s["name"] in ("ingest", "write"):
            assert s["parent"] == call["id"]
        if s["name"] == "ingest.read":
            assert by_id[s["parent"]]["name"] == "ingest"
        if s["name"] == "fusion_plan":
            assert by_id[s["parent"]]["name"] == "plot"
    assert {s["request"] for s in spans if s["name"] == "ingest.wait"} == {
        0, 1}


def test_worker_spans_map_inside_the_call_on_the_profilers_clock(traced):
    """The profiler sees only the main thread; the anchor puts the worker
    thread's spans inside the call's own range on its clock."""
    (ev,) = [e for e in traced["events"] if e.name() == "predict"]
    lo, hi = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    spans = traced["rec"]["spans"]
    assert not [e for e in traced["events"] if e.name() == "ingest.read"]
    workers = [s for s in spans if s["thread"] != "MainThread"]
    assert len(workers) >= 10
    for s in workers:
        assert lo <= s["trace_start_ns"] <= s["trace_end_ns"] <= hi, s
    (call,) = [s for s in spans if s["name"] == "predict"]
    # the span starts inside its range, after the range's own stamp
    assert 0 <= call["trace_start_ns"] - lo < 5_000_000


def test_main_thread_spans_open_profiler_ranges(traced):
    names = {e.name() for e in traced["events"]}
    assert {"plot", "model", "model.forward", "model.batch", "fusion",
            "fusion.select", "fusion.readback", "ingest.wait"} <= names


def test_batch_counters(traced):
    c = traced["rec"]["counters"]
    assert c["batch.slots"] >= c["batch.points"] > 0
    tiles = sum(r["tiles"] for r in traced["records"])
    pads = [s for s in traced["rec"]["spans"] if s["name"] == "batch.pad"]
    assert pads and sum(s["name"] == "model.batch"
                        for s in traced["rec"]["spans"]) == len(pads) + 2
    assert tiles > 0


def test_index_fusion_counts_the_host_rows_it_prints(files, capsys,
                                                    tmp_path):
    """One 4 m grid at any-wood 0.5 takes the index path; the loose cell's
    rows are searched on the host, as many as the ``fusion:`` line says.
    Run under ``--profile DIR``: tracing on for the whole call, and
    ``program_spans.json`` on ``model_phase.json``'s clock."""
    trace.reset()
    capsys.readouterr()
    (r,) = cli.main(["--point-cloud", files["loose"], "--model",
                     files["model"], "--grid_size", "4.0", "--any-wood",
                     "0.5", "--profile", str(tmp_path)] + FLAGS,
                    device="cpu")
    rec = trace.collected()
    trace.reset()
    (line,) = [s for s in capsys.readouterr().out.splitlines()
               if s.startswith("fusion:")]
    assert "index path" in line
    printed = int(re.search(r"(\d+) searched on the host", line)[1])
    assert printed >= 40
    assert rec["counters"]["fusion.host_rows"] == printed
    names = {s["name"] for s in rec["spans"]}
    assert {"fusion_index", "fusion.index.cells", "fusion.index.knn",
            "fusion.index.merge", "fusion.host_search", "ingest.read",
            "write"} <= names
    assert set(r["seconds"]) == INDEX_KEYS

    model = json.loads((tmp_path / "model_phase.json").read_text())
    spans = json.loads((tmp_path / "program_spans.json").read_text())
    assert spans["baseTimeNanoseconds"] == model["baseTimeNanoseconds"]
    (ev,) = [e for e in model["traceEvents"] if e.get("name") == "model.batch"
             and e.get("ph") == "X"][:1]
    (mine,) = [e for e in spans["traceEvents"]
               if e["name"] == "model.batch"][:1]
    # the same range, stamped by the profiler and placed by the anchor
    assert abs(mine["ts"] - ev["ts"]) < 5_000
    assert {e["tid"] for e in spans["traceEvents"]} > {"MainThread"}


def test_train_step_splits_with_host_marks():
    """A CPU step under a profiler: four step spans in order, each with
    marks on the host clock (CUDA events' stand-in), the step's number as
    its request."""
    torch.manual_seed(0)
    net = build_net(ModelConfig(channels=8, compute_dtype="float32"),
                    device="cpu")
    cfg = TrainConfig(batch_size=2)
    step = make_train_step(net, make_optimizer(net, cfg), cfg)
    g = torch.Generator().manual_seed(0)
    n = 256
    pos = torch.randn(2, n, 3, generator=g)
    refl = torch.randn(2, n, generator=g)
    mask = torch.ones(2, n, dtype=torch.bool)
    sf = pos.norm(dim=-1).amax(1)
    labels = (torch.rand(2, n, generator=g) > 0.5).float()
    trace.reset()
    step(pos, refl, mask, sf, labels, 1e-4, g)  # tracing off: nothing
    assert trace.collected()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            _, _, finite = step(pos, refl, mask, sf, labels, 1e-4, g)
            assert finite
    rec = trace.collected()
    trace.reset()
    steps = [s for s in rec["spans"] if s["name"] == "step"]
    assert [s["request"] for s in steps] == [1, 2]
    parts = ["step.forward", "step.backward", "step.guard", "step.update"]
    for st in steps:
        kids = sorted((s for s in rec["spans"] if s["parent"] == st["id"]),
                      key=lambda s: s["start_ns"])
        assert [s["name"] for s in kids] == parts
        edges = [m for s in kids for m in s["device_ms"]]
        assert edges == sorted(edges) and edges[0] >= 0
        for s in kids:
            host = (s["end_ns"] - s["start_ns"]) * 1e-6
            dev = s["device_ms"][1] - s["device_ms"][0]
            assert abs(dev - host) < 1.0 and s["request"] == st["request"]


def test_marks_are_read_only_when_collected(monkeypatch):
    """A traced step records its marks and reads none of them (a read of
    a CUDA event waits for the device); ``collected()`` reads them."""
    reads = []

    class Event:  # a CUDA event's record-only stand-in
        def __init__(self):
            self.t = time.perf_counter_ns()

        def elapsed_time(self, other):
            reads.append(other)
            return (other.t - self.t) * 1e-6

    monkeypatch.setattr(trace, "_mark",
                        lambda device: Event() if device is not None else 0)
    torch.manual_seed(0)
    net = build_net(ModelConfig(channels=8, compute_dtype="float32"),
                    device="cpu")
    cfg = TrainConfig(batch_size=1)
    step = make_train_step(net, make_optimizer(net, cfg), cfg)
    g = torch.Generator().manual_seed(0)
    pos = torch.randn(1, 256, 3, generator=g)
    args = (pos, torch.randn(1, 256, generator=g),
            torch.ones(1, 256, dtype=torch.bool), pos.norm(dim=-1).amax(1),
            (torch.rand(1, 256, generator=g) > 0.5).float(), 1e-4, g)
    trace.reset()
    with trace.session():
        step(*args)
    assert reads == []
    rec = trace.collected()
    trace.reset()
    assert len(reads) == 8
    assert all(s["device_ms"] is not None for s in rec["spans"]
               if s["name"].startswith("step."))


def test_threads_record_without_losing_spans_or_counts():
    """Spans and counts from more threads than cores, switching often:
    none is lost, ids stay unique, each thread's parents are its own."""
    n_threads, n = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.reset()
    try:
        with trace.session():
            def work(i):
                with trace.span("outer", request=i):
                    for _ in range(n):
                        with trace.span("inner"):
                            trace.count("c", 1)

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        rec = trace.collected()
    finally:
        sys.setswitchinterval(old)
        trace.reset()
    spans = rec["spans"]
    assert len(spans) == n_threads * (n + 1)
    assert len({s["id"] for s in spans}) == len(spans)
    assert rec["counters"]["c"] == n_threads * n
    outer = {s["id"]: s for s in spans if s["name"] == "outer"}
    for s in spans:
        if s["name"] == "inner":
            up = outer[s["parent"]]
            assert (up["thread"], up["request"]) == (s["thread"],
                                                     s["request"])


def test_graph_marks_record_a_capture_and_add_it_at_each_replay():
    """A ``GraphMarks`` recording (a captured graph's pass; the CPU's
    stand-in stamps the host clock) keeps the spans with device marks in
    their stamp slots, and the counters; tracing stays off and other
    threads record nothing into it. Each traced ``replayed()`` adds them
    as children of the open span, with device marks; off, it adds
    nothing."""
    marks = trace.GraphMarks("cpu", slots=8)
    other = []

    def elsewhere():
        other.append(trace.span("x", marks="cpu") is trace.NULL)

    trace.reset()
    with marks.recording():
        assert trace.active() and not trace.TRACER.on
        with trace.span("pt.fps", marks="cpu"):
            with trace.span("unmarked"):
                trace.count("pt.pairs", torch.tensor(7))
        with trace.span("pt.knn", marks="cpu"):
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join()
    assert not trace.active() and other == [True]
    assert [(n, a < b) for n, a, b in marks.spans] == [("pt.fps", True),
                                                       ("pt.knn", True)]
    assert marks.used == 5 and trace.collected()["spans"] == []
    marks.replayed(marks.before())  # tracing off: nothing
    with trace.session():
        for step in range(2):
            with trace.span("step.forward", request=step, marks="cpu"):
                before = marks.before()
                marks.replayed(before)
    rec = trace.collected()
    trace.reset()
    fwd = {s["id"]: s for s in rec["spans"] if s["name"] == "step.forward"}
    replayed = [s for s in rec["spans"] if s["parent"] in fwd]
    assert sorted((s["request"], s["name"]) for s in replayed) == [
        (0, "pt.fps"), (0, "pt.knn"), (1, "pt.fps"), (1, "pt.knn")]
    for s in replayed:
        a, b = s["device_ms"]
        assert s["attrs"] == {"replayed": True} and 0 <= a < b
    assert rec["counters"] == {"pt.pairs": 14}
