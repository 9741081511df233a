#!/usr/bin/env python3
"""Where a benchmark cell's traced window goes, from the port's own spans.

    python3 trace_report.py --workload <cell> --seed <n> --seconds <s> \\
        [--out build/trace_report-<cell>.json]

Sets up one cell of ``BENCHMARK.json`` as ``portbench/run.py`` does,
runs its window with the traced part on, and reports, without judging
the outputs:

* ``metrics``: the cell's per-layer metrics, as ``--trace 1`` reads them;
* ``spans``: host seconds by span name of ``pointstowood_tpu_torch``'s
  tracer (``utils/trace.py``), and by request (plot or step);
* ``steps``: each traced train step's device milliseconds by part
  (``step.*`` marks) and the host's wait in ``step.guard``;
* ``idle_main``: the device's idle gaps of 20 us or more, each put down
  to the innermost program span open on the main thread at its middle,
  with the worker thread's span open then (``idle_cross``: the same
  gaps by the benchmark's own label, ``portbench/trace.reduce``).

Spans of every thread are placed on the device trace's clock through
the tracer's anchors (``trace.resolve``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _device_gaps(events, short_ns):
    from portbench.trace import WINDOW, _is_device

    win = [e for e in events if e.name() == WINDOW
           and "CPU" in str(e.device_type())]
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    dev = sorted((max(e.start_ns(), w0),
                  min(e.start_ns() + e.duration_ns(), w1))
                 for e in events if _is_device(e))
    merged = []
    for s, t in dev:
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps, edge = [], w0
    for s, t in merged + [[w1, w1]]:
        if s - edge >= short_ns:
            gaps.append((edge, s))
        edge = max(edge, t)
    return w0, w1, gaps


def _innermost(spans, t):
    open_ = [s for s in spans if s["trace_start_ns"] <= t <= s["trace_end_ns"]]
    if not open_:
        return None
    return min(open_, key=lambda s: s["trace_end_ns"] - s["trace_start_ns"])


def idle_by_thread(events, rec, short_ns=20_000) -> dict:
    """Idle seconds by the main thread's innermost open span, and within
    each label by the worker span open at the gap's middle."""
    w0, w1, gaps = _device_gaps(events, short_ns)
    main = [s for s in rec["spans"] if s["thread"] == "MainThread"]
    work = [s for s in rec["spans"] if s["thread"] != "MainThread"]
    out: dict = {}
    for s, t in gaps:
        mid = (s + t) / 2
        m, w = _innermost(main, mid), _innermost(work, mid)
        key = m["name"] if m else "outside the program's spans"
        row = out.setdefault(key, {"s": 0.0, "with_worker": {}})
        row["s"] += (t - s) * 1e-9
        wk = w["name"] if w else "none"
        row["with_worker"][wk] = row["with_worker"].get(wk, 0.0) + (
            t - s) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "idle": dict(sorted(out.items(), key=lambda kv: -kv[1]["s"]))}


def span_seconds(rec) -> dict:
    by_name: dict = {}
    by_request: dict = {}
    for s in rec["spans"]:
        d = (s["end_ns"] - s["start_ns"]) * 1e-9
        by_name[s["name"]] = by_name.get(s["name"], 0.0) + d
        per = by_request.setdefault(str(s["request"]), {})
        per[s["name"]] = per.get(s["name"], 0.0) + d
    return {"by_name": dict(sorted(by_name.items())),
            "by_request": by_request}


def step_parts(rec) -> list:
    from portbench.layers import _program

    rows = []
    for st in _program.steps(rec):
        row = {}
        for name, s in st.items():
            if s["device_ms"] is not None:
                row[name] = s["device_ms"][1] - s["device_ms"][0]
        if "step.update" in st and "step.backward" in st:
            row["update_from_backward"] = (
                st["step.update"]["device_ms"][1]
                - st["step.backward"]["device_ms"][1])
        if "step.guard" in st:
            g = st["step.guard"]
            row["guard_host"] = (g["end_ns"] - g["start_ns"]) * 1e-6
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    run.cache_dirs()
    import torch

    from portbench import harness, manifest
    from portbench.trace import Tracer
    from pointstowood_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        print("trace_report: needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load(args.workload)
    c = harness.make(cell, args.seed, torch.device("cuda"))
    try:
        t0 = time.perf_counter()
        c.setup()
        setup_s = time.perf_counter() - t0
        tracer = Tracer(True)
        trace.reset()
        c.window(args.seconds, tracer)
        torch.cuda.synchronize()
        view = dict(c.view(), model=cell.config["model"])
        metrics = {m["name"]: manifest.reader(m["name"])(view)
                   for m in cell.per_layer}
        found = trace.resolve(tracer.events)
        rec = trace.collected()
        report = {
            "workload": args.workload, "seed": args.seed,
            "device": torch.cuda.get_device_name(0), "setup_s": setup_s,
            "anchors_resolved": found, "anchors": len(rec["anchors"]),
            "metrics": metrics, "counters": rec["counters"],
            "spans": span_seconds(rec), "steps": step_parts(rec),
            "idle_main": idle_by_thread(tracer.events, rec),
            "idle_cross": view["trace"]["breakdown"]["idle_gaps"],
            "busy_s": view["trace"]["busy_s"],
        }
    finally:
        c.close()
    out = args.out or str(ROOT / "build"
                          / f"trace_report-{args.workload}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    short = {k: report[k] for k in ("workload", "metrics", "busy_s",
                                    "idle_cross", "anchors_resolved")}
    short["idle_main"] = {k: round(v["s"], 4) for k, v in
                          report["idle_main"]["idle"].items()}
    print(json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
