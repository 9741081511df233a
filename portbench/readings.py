#!/usr/bin/env python3
"""The readings the limits of ``limits/<cell>.json`` are set from, many
seeds in one process (set-up, kernels and CUDA context load once).

    python3 portbench/readings.py --workload <cell> --seconds 1 \\
        --seeds 11 12 ... --control-seeds 11 12 13 \\
        [--faults half_batch state_unchanged] --out readings.jsonl

For each seed of ``--seeds`` a short run of the program (its numbers
beside the current limits); for each of ``--control-seeds`` the control,
the reference in float8 products in the program's place; for each fault
and each of the first three seeds, a run with that fault planted. One
JSON line per run to ``--out`` and standard output. Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--dtype", default=None,
                   help="run the program in this compute dtype instead of "
                        "the configuration's (a second witness)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, manifest
    from portbench.kinds import train

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load(args.workload)
    if args.dtype:
        cell.config["model"]["compute_dtype"] = args.dtype
    plan = ([(s, None, None) for s in args.seeds]
            + [(s, "fp8", None) for s in args.control_seeds]
            + [(s, None, f) for f in args.faults for s in args.seeds[:3]])
    with open(args.out, "a") as out:
        for seed, control, fault in plan:
            run = argparse.Namespace(workload=args.workload, seed=seed,
                                     seconds=args.seconds, trace=0,
                                     control=control, fault=fault)
            t0 = time.perf_counter()
            train.DETAILS.clear()
            result, checks = harness.run(cell, run, "cuda", t0)
            c_all = dict(harness.LAST)
            line = {"workload": args.workload, "seed": seed,
                    "mode": control or fault or args.dtype or "program",
                    "details": train.DETAILS,
                    "all": c_all,
                    "correct": result["correct"],
                    "numbers": {k: v for k, (v, _) in checks.items()},
                    "metrics": {k: v["value"]
                                for k, v in result["metrics"].items()},
                    "seconds": time.perf_counter() - t0}
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
