"""Small versions of the benchmark's cells, for runs on the CPU: the same
kinds, limits and metrics, the cell's configuration (its architecture
too) at C=8, and plots of a few thousand points."""

import argparse
import time
import types

from portbench import harness, manifest

CHANNELS = 8

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

# small traffic by the name of the cell's traffic, so that a cell added
# under one of these mixes gets its small version with no edit here
TRAFFIC = {"predict-plot": PREDICT, "predict-largetile": LARGETILE,
           "train-b8": TRAIN}


def cell(name: str, model: dict | None = None):
    """The named cell of BENCHMARK.json (its limits and metrics) with the
    small traffic and ``model`` (by default the cell's configuration's)
    cut to ``CHANNELS``."""
    real = manifest.load(name)
    traffic = TRAFFIC[real.traffic_name]
    model = dict(model or real.config["model"], channels=CHANNELS)
    if traffic["kind"] == "train":
        # at C=8 on 2048-point tiles a bfloat16 step's worst leaf moves
        # further from float32 than at the cells' sizes; the float32
        # program (the second witness of the limits) is judged here
        model["compute_dtype"] = "float32"
    return types.SimpleNamespace(
        name=name, chips=1, config=dict(model=model), traffic=traffic,
        limits=real.limits, end_to_end=real.end_to_end,
        per_layer=real.per_layer)


def run(name: str, seed: int = 2**31 + 11, trace: int = 0, control=None,
        fault=None, model: dict | None = None):
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.1,
                              trace=trace, control=control, fault=fault)
    return harness.run(cell(name, model), args, "cpu", time.perf_counter())
