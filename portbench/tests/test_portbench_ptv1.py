"""The ``train-b8.ptv1-seg50`` cell at a small size on the CPU
(``tiny.py``: the cell's limits and metrics, Point Transformer at C=8 in
float32, 1024-2048-point tiles): a sound run is correct and its traced
window reads the cell's metrics; each fault planted in the timed path,
and the fp8 control, is not correct. ``arch/ptv1.py``'s layout is the
program's ``state_dict``, key for key and shape for shape."""

import json

import numpy as np
import pytest
import torch

from portbench import arch, manifest
from portbench.tests import tiny

CELL = "train-b8.ptv1-seg50"


def test_config_file_as_run():
    """The published widths and depths, nothing reduced."""
    bench = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "ptv1-seg50")
    data = json.loads((manifest.ROOT / conf["file"]).read_text())
    assert data["name"] == "ptv1-seg50"
    assert data["reduced"] == conf["reduced"] == []
    model = data["model"]
    assert (model["arch"], model["channels"], model["share_planes"]) == (
        "ptv1", 32, 8)
    assert (model["blocks"], model["stride"], model["nsample"]) == (
        [2, 3, 4, 6, 3], [1, 4, 4, 4, 4], [8, 16, 16, 16, 16])
    shapes = arch.load(model).param_shapes(model)
    assert sum(int(np.prod(s)) for k, s in shapes.items()
               if not k.endswith("num_batches_tracked")) > 7.7e6


def test_layout_is_the_programs_state_dict():
    model = dict(manifest.load(CELL).config["model"], channels=tiny.CHANNELS)
    ptv1 = arch.load(model)
    shapes = ptv1.param_shapes(model)
    got = {k: tuple(v.shape) for k, v in ptv1.build(model).state_dict()
           .items()}
    assert list(got) == list(shapes)
    assert got == {k: tuple(v) for k, v in shapes.items()}


def test_forward_work_counts_every_level():
    model = manifest.load(CELL).config["model"]
    ptv1 = arch.load(model)
    ops, flops = ptv1.forward_work({"n": torch.tensor([16384, 8192])},
                                   model, True)
    kinds = [o["op"] for o in ops]
    assert kinds.count("fps") == 4 and kinds.count("blend") == 4
    assert kinds.count("blend_bwd") == 4 and kinds.count("search") == 13
    fps = [o for o in ops if o["op"] == "fps"][0]
    assert fps["ops"] == 10 * (4096 * 16384 + 2048 * 8192)
    assert flops > 0


def test_sound_run_is_correct_and_reads_its_layers():
    result, checks = tiny.run(CELL, trace=1)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    metrics = result["metrics"]
    assert {"train.fps_ms", "train.attention_ms", "mfu.train"} <= set(
        metrics)
    assert metrics["train.fps_ms"]["value"] > 0
    assert metrics["mfu.train"]["value"] > 0


@pytest.mark.parametrize("mode", [dict(fault="half_batch"),
                                  dict(fault="state_unchanged"),
                                  dict(control="fp8")])
def test_fault_is_not_correct(mode):
    result, checks = tiny.run(CELL, **mode)
    assert not result["correct"], checks
