"""Small versions of the benchmark's cells, for runs on the CPU: the same
kinds, limits and metrics at C=8 and plots of a few thousand points."""

import argparse
import time
import types

from portbench import harness, manifest

MODEL = dict(num_classes=1, channels=8, k=32, sa_resolutions=[0.04, 0.08, 0.16],
             stage_fractions=[0.5, 0.5, 0.5], fp_k=2, knn_mode="fast",
             compute_dtype="bfloat16", voxel_priority="hash",
             attention_knn=False)

PREDICT = dict(
    kind="predict", layout_seed=5,
    plots=[dict(seed_offset=0, n_side=1, density=0.3),
           dict(seed_offset=1, n_side=1, density=0.3)],
    argv=["--grid_size", "2.0", "4.0", "--min_pts", "128", "--max_pts",
          "2048", "--batch_size", "2", "--is-wood", "0.5", "--any-wood", "1"],
    warmup_plot=dict(seed_offset=7, n_side=1, density=0.1),
    calibration=dict(tiles=2, capacity=2048),
    check=dict(anchors=2, uncovered_rows=0, net_tiles=64))

LARGETILE = dict(PREDICT, argv=[
    "--grid_size", "4.0", "--min_pts", "128", "--max_pts", "4096",
    "--batch_size", "2", "--is-wood", "0.5", "--any-wood", "0.5"],
    check=dict(anchors=2, uncovered_rows=16, net_tiles=64))

TRAIN = dict(kind="train", layout_seed=6, plot=dict(n_side=1, density=0.3),
             grid_size=[2.0, 4.0], min_pts=1024, max_pts=2048, batch_size=2,
             learning_rate=1e-4, judged_steps=3, traced_steps=2,
             judged_window_step=[9, 10])

CELLS = {"predict-plot.ptw-net-c32": PREDICT,
         "predict-largetile.ptw-net-c32": LARGETILE,
         "train-b8.ptw-net-c32": TRAIN,
         "train-b8.ptw-attknn-c32": TRAIN}


def cell(name: str):
    """The named cell of BENCHMARK.json (its limits and metrics) with the
    small configuration and traffic."""
    real = manifest.load(name)
    model = dict(MODEL, attention_knn=real.config["model"]["attention_knn"])
    if CELLS[name]["kind"] == "train":
        # at C=8 on 2048-point tiles a bfloat16 step's worst leaf moves
        # further from float32 than at the cells' sizes; the float32
        # program (the second witness of the limits) is judged here
        model["compute_dtype"] = "float32"
    return types.SimpleNamespace(
        name=name, chips=1, config=dict(model=model), traffic=CELLS[name],
        limits=real.limits, end_to_end=real.end_to_end,
        per_layer=real.per_layer)


def run(name: str, seed: int = 2**31 + 11, trace: int = 0, control=None,
        fault=None):
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.1,
                              trace=trace, control=control, fault=fault)
    return harness.run(cell(name), args, "cpu", time.perf_counter())
