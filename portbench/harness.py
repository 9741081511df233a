"""One run of one cell: set-up, the measured window, the metrics, the
judgement. Device-agnostic below ``run.py``'s check for the chip, so the
CPU tests drive it whole at a small size."""

from __future__ import annotations

import importlib
import sys
import time

import torch

from portbench import manifest
from portbench.trace import Tracer


def make(cell, seed: int, device, fault=None):
    """The cell's traffic kind, ``kinds/<kind>.py`` by its traffic file's
    ``kind``."""
    mod = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    return mod.Cell(cell, seed, device, fault=fault)


LAST = {}  # every number of the last judgement, for readings.py


def judge(cell, numbers: dict) -> tuple[bool, dict]:
    """The numbers the cell's limits name, each with its limit; correct
    when none is over its limit (a number missing is not correct)."""
    LAST.clear()
    LAST.update(numbers)
    checks = {k: (numbers.get(k), lim) for k, lim in cell.limits.items()}
    ok = all(v is not None and v <= lim for v, lim in checks.values())
    return ok, checks


def _metric(entry, value) -> dict:
    return {"value": value, "unit": entry["unit"]}


def run(cell, args, device: str, t_start: float):
    """(result line, checks) of one run. With ``args.control`` the window
    runs untraced and the control is judged in the program's place."""
    dev = torch.device(device)
    c = make(cell, args.seed, dev, fault=args.fault)
    try:
        c.setup()
        setup_s = time.perf_counter() - t_start
        tracer = Tracer(args.trace == 1 and not args.control)
        c.window(args.seconds, tracer)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        info = device_info(dev, cell)
        metrics, breakdown = {}, None
        if tracer.enabled:
            view = dict(c.view(), model=cell.config["model"])
            summary = view["trace"]
            for entry in cell.per_layer:
                value = manifest.reader(entry["name"])(view)
                if value is not None:
                    metrics[entry["name"]] = _metric(entry, value)
            print(f"portbench: traced {summary['window_s']:.3f} s, "
                  f"{summary['op_spans']} operation spans: "
                  f"{summary['op_s']}", file=sys.stderr)
            info["busy_s"] = summary["busy_s"]
            info["window_s"] = summary["window_s"]
            breakdown = summary["breakdown"]
        elif not args.control:
            e2e = dict(c.end_to_end(), setup_s=setup_s)
            for entry in cell.end_to_end:
                metrics[entry["name"]] = _metric(entry, e2e[entry["name"]])
        c.release()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ok, checks = judge(cell, c.check(control=args.control))
        result = {"correct": ok, "attempted": c.attempted(),
                  "failed": getattr(c, "failed", lambda: 0)(),
                  "metrics": metrics, "device": info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = _plain(checks)
        return result, checks
    finally:
        c.close()


def _plain(checks: dict) -> dict:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def device_info(dev, cell) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
