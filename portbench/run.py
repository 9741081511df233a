#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port ``pointstowood_tpu_torch`` on NVIDIA
GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One run: set up the cell of ``BENCHMARK.json`` named by ``--workload``
(its configuration ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` read by the generator ``kinds/<kind>.py``),
warm it, measure for ``--seconds``, judge what the timed path produced
against the plain reference (``reference/``, limits in
``limits/<cell>.json``), and print one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, each read by
``layers/<metric>.py``), ``device`` (and ``breakdown`` when traced), then
``checks``: each number compared with its limit, also printed as the last
lines of standard error.

``--control fp8`` puts the reference in float8 products in the program's
place and prints the numbers it reads (the window runs untraced, and no
metric is reported); ``--fault`` plants a fault in the timed path. Both
exist to set and prove the limits.

Exits non-zero, printing no result, without enough CUDA devices, or if
the JAX package or JAX was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "pointstowood_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8",), default=None)
    p.add_argument("--fault", default=None,
                   choices=("half_batch", "state_unchanged", "flip_labels"))
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package
    (whole names: ``pointstowood_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs() -> None:
    """Build caches at fixed paths inside the checkout."""
    base = ROOT / "build" / "portbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))


def main(argv=None) -> int:
    args = parse_args(argv)
    # the checkout root, not this directory: portbench's modules are
    # imported as a package, and none may shadow a library's module
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    cache_dirs()
    import torch

    from portbench import harness, manifest

    cell = manifest.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    result, checks = harness.run(cell, args, "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
