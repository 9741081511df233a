"""Whole runs of small cells on the CPU: the harness without its look for
a chip. A sound run is correct; each fault the cell can have, planted in
the timed path, and the control (the reference in float8 products in the
program's place) are not."""

import pytest

from portbench.tests import tiny


@pytest.mark.parametrize("name", ["predict-plot.ptw-net-c32",
                                  "predict-largetile.ptw-net-c32",
                                  "train-b8.ptw-net-c32"])
def test_sound_run_is_correct(name):
    result, checks = tiny.run(name)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("name,fault", [
    ("predict-plot.ptw-net-c32", "half_batch"),
    ("predict-plot.ptw-net-c32", "flip_labels"),
    ("train-b8.ptw-net-c32", "half_batch"),
    ("train-b8.ptw-net-c32", "state_unchanged"),
])
def test_fault_is_not_correct(name, fault):
    result, checks = tiny.run(name, fault=fault)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", ["predict-plot.ptw-net-c32",
                                  "train-b8.ptw-net-c32"])
def test_control_is_not_correct(name):
    result, checks = tiny.run(name, control="fp8")
    assert not result["correct"], checks


def test_traced_run_reads_its_layers():
    result, _ = tiny.run("train-b8.ptw-net-c32", trace=1)
    assert {"train.host_ms_per_step", "mfu.train"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["predict-plot.ptw-net-c32",
                                  "train-b8.ptw-net-c32"])
def test_cell_on_the_card(card, name):
    import argparse
    import time

    from portbench import harness, manifest

    args = argparse.Namespace(workload=name, seed=2**31 + 21, seconds=2,
                              trace=0, control=None, fault=None)
    result, checks = harness.run(manifest.load(name), args, "cuda",
                                 time.perf_counter())
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_from_the_window_on_is_not_correct(monkeypatch, fault):
    """A fault that sets in only after set-up's judged steps is caught by
    the judged window step."""
    from portbench.kinds import train

    window = train.Cell.window

    def late(self, *args):
        self.fault = fault
        return window(self, *args)

    monkeypatch.setattr(train.Cell, "window", late)
    result, checks = tiny.run("train-b8.ptw-net-c32")
    assert not result["correct"], checks
    assert any(k.startswith("window_") and v > lim
               for k, (v, lim) in checks.items())
