"""What a refactor of the harness must leave as it was, on the CPU: every
tiny cell of ``BENCHMARK.json`` (``tiny.run``) at two seeds, untraced,
traced, under the fp8 control and under the ``half_batch`` fault, with
its result's ``checks``, ``correct``, ``attempted``, ``failed`` and
metric names, a digest of each tensor of the cell's seeded weights
(calibrated, for predict) and ``Work.ops_and_flops()``, written as one
JSON file.

    python3 portbench/tests/identity.py <parent checkout> parent.json
    python3 portbench/tests/identity.py . change.json
    cmp parent.json change.json

The checkout given is put first on ``sys.path``, so one copy of this
file measures both sides. About 8 minutes a side on two threads.
"""

import hashlib
import json
import sys

SEEDS = (2**31 + 101, 5_000_000_017)
MODES = (dict(), dict(trace=1), dict(control="fp8"),
         dict(fault="half_batch"))


def digest(tensors: dict) -> dict:
    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()[:16]
            for k, v in tensors.items()}


def main(root: str, out_path: str) -> None:
    sys.path.insert(0, root)
    import torch

    from portbench import harness
    from portbench.tests import tiny

    torch.set_num_threads(2)
    made, make = [], harness.make

    def recording_make(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    harness.make = recording_make
    bench = json.load(open(f"{root}/BENCHMARK.json"))
    res = {}
    for name in (w["name"] for w in bench["workloads"]):
        for seed in SEEDS:
            for mode in MODES:
                made.clear()
                result, _ = tiny.run(name, seed=seed, **mode)
                c = made[0]
                ops, flops = (c.work.ops_and_flops() if c.work
                              else ([], 0.0))
                w = getattr(c, "weights", None) or c.w0
                key = f"{name}|{seed}|{json.dumps(mode, sort_keys=True)}"
                res[key] = {k: result[k] for k in
                            ("checks", "correct", "attempted", "failed")}
                res[key].update(metric_names=sorted(result["metrics"]),
                                weights=digest(w), ops=ops, flops=flops)
                print(key, result["correct"], len(ops), flops, flush=True)
    with open(out_path, "w") as f:
        json.dump(res, f, sort_keys=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
