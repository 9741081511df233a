"""The per-layer metrics read from the program's own spans and counters
(``pointstowood_tpu_torch.utils.trace``): on the small cells with
``--trace 1`` each reads a finite number, and the predict readers count
the traced call alone."""

import math

import pytest

from portbench import manifest
from portbench.tests import tiny

NEW = {
    "predict-plot.ptw-net-c32": [
        "predict.ingest_wait_s_per_mpt", "predict.batch_host_s_per_mpt",
        "pad_share.predict"],
    "predict-largetile.ptw-net-c32": [
        "predict.ingest_wait_s_per_mpt", "predict.batch_host_s_per_mpt",
        "pad_share.predict", "predict.fusion_host_search_s_per_mpt",
        "predict.fusion_host_rows_per_mpt"],
    "train-b8.ptw-net-c32": [
        "pad_share.train", "train.batch_ms_per_step", "train.forward_ms",
        "train.backward_ms", "train.update_ms", "train.guard_wait_ms"],
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_program_metrics_read_finite_numbers(name):
    from pointstowood_tpu_torch.utils import trace

    trace.reset()
    try:
        result, checks = tiny.run(name, trace=1)
        rec = trace.collected()
    finally:
        trace.reset()
    assert result["correct"], checks
    listed = {m["name"] for m in manifest.load(name).per_layer}
    assert set(NEW[name]) <= listed
    for metric in NEW[name]:
        value = result["metrics"][metric]["value"]
        assert math.isfinite(value), metric
    spans = rec["spans"]
    if name.startswith("predict"):
        # set-up's warm-up call and the window's untraced call are not
        # counted: one call, its two plots
        assert sum(s["name"] == "predict" for s in spans) == 1
        assert sorted(s["request"] for s in spans
                      if s["name"] == "plot") == [0, 1]
        wait = sum(s["end_ns"] - s["start_ns"] for s in spans
                   if s["name"] == "ingest.wait") * 1e-9
        pts = sum(len(t["x"]) for t in _tables(name))
        assert result["metrics"]["predict.ingest_wait_s_per_mpt"][
            "value"] == pytest.approx(wait / pts * 1e6)
    else:
        steps = [s for s in spans if s["name"] == "step"]
        assert len(steps) == tiny.TRAIN["traced_steps"]
        assert 0 <= result["metrics"]["pad_share.train"]["value"] < 100


def _tables(name):
    from portbench import plots

    traffic = tiny.cell(name).traffic
    return [plots.synthetic_plot(traffic["layout_seed"] + p["seed_offset"],
                                 p["n_side"], p["density"],
                                 seed=2**31 + 11 + p["seed_offset"])[0]
            for p in traffic["plots"]]


def test_readers_return_nothing_without_program_spans():
    """Where the program records nothing (a program without the tracer),
    every new reader returns None and raises nothing."""
    from pointstowood_tpu_torch.utils import trace

    trace.reset()
    view = {"calls": [], "steps": [], "trace": None}
    for names in NEW.values():
        for metric in names:
            assert manifest.reader(metric)(view) is None, metric
