"""Time the port's single-card train step of two checkouts in turns.

    python ab_train_step.py DIR_A DIR_B [--out FILE]

Runs ``chip_smoke.train_step_phase`` (B = 8 x 16384, C = 32, bf16, fast
kNN, seeded weights: the median of 10 steps, its forward / backward /
optimizer split, the peak memory and a profiled step) in a fresh process
for each of A, B, G, S, S, G, B, A, where DIR_A and DIR_B are checkouts
of the repo (each holding ``chip_smoke.py`` and ``pointstowood_tpu_torch``),
G is B's net as a data group of one (``set_data_group(net, DataGroup(0, 1,
None))``: the data-parallel numerics without collectives, float64 batch
statistics and products a sample at a time) and S the group on the
BatchNorms and SA stages alone (float64 statistics, batched products):
G - S is what the products a sample at a time cost. One line of
JSON a run to ``--out`` (default ``build/ab_train_step.jsonl``), a
summary line a run to standard output. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = """
import json, sys, torch
import chip_smoke as c
if sys.argv[2] != "":
    from pointstowood_tpu_torch.model.layers import MaskedBatchNorm
    from pointstowood_tpu_torch.model.network import SAStage
    from pointstowood_tpu_torch.parallel.mesh import DataGroup
    from pointstowood_tpu_torch.train import trainer
    build = trainer.build_train_net

    def grouped(*a, **k):
        net = build(*a, **k)
        for mod in net.modules():
            if hasattr(mod, "data_group") and (sys.argv[2] == "G" or
                    isinstance(mod, (MaskedBatchNorm, SAStage))):
                mod.data_group = DataGroup(0, 1, None)
        return net

    trainer.build_train_net = grouped
rec, _ = c.train_step_phase(torch.device("cuda"), sys.argv[1], {}, c.SEED,
                            required={})
prof = [r for r in c.RECORDS if r["phase"] == "train_profile"][0]
keep = ("step_ms", "step_ms_all", "forward_ms", "backward_ms",
        "optimizer_ms", "max_memory_gib", "losses")
print(json.dumps({**{k: rec[k] for k in keep},
                  "device_busy_ms": prof["device_busy_ms"],
                  "top_kernels_ms": prof["top_kernels_ms"][:12]}))
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--out", default=os.path.join(
        "build", "ab_train_step.jsonl"))
    opts = parser.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    runs = [("A", opts.a), ("B", opts.b), ("G", opts.b), ("S", opts.b),
            ("S", opts.b), ("G", opts.b), ("B", opts.b), ("A", opts.a)]
    with open(opts.out, "w") as f:
        for name, tree in runs:
            done = subprocess.run(
                [sys.executable, "-c", _RUN, smi,
                 name if name in "GS" else ""],
                cwd=os.path.abspath(tree), capture_output=True, text=True,
                env=dict(os.environ, PYTHONPATH=os.path.abspath(tree)))
            if done.returncode:
                sys.stderr.write(done.stdout[-4000:] + done.stderr[-4000:])
                return done.returncode
            rec = {"run": name, "tree": tree, "nvidia_smi": smi,
                   **json.loads(done.stdout.strip().splitlines()[-1])}
            f.write(json.dumps(rec) + "\n")
            print(name, tree, rec["step_ms"], rec["forward_ms"],
                  rec["backward_ms"], rec["optimizer_ms"],
                  rec["max_memory_gib"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
