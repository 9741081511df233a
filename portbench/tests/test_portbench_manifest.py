"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name in it."""

import json
import re

import pytest

from portbench import arch, manifest

BENCH = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = manifest.load(name)
    assert cell.traffic["kind"]
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    assert all(isinstance(v, (int, float)) for v in cell.limits.values())


@pytest.mark.parametrize("name", sorted({c["name"] for c in BENCH["configs"]}))
def test_config_file_as_run(name):
    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    data = json.loads((manifest.ROOT / conf["file"]).read_text())
    assert data["name"] == name and data["reduced"] == conf["reduced"] == []
    model = data["model"]
    assert (model["channels"], model["k"], model["fp_k"]) == (32, 32, 2)
    assert model["sa_resolutions"] == [0.04, 0.08, 0.16]
    assert len(arch.load(model).param_shapes(model)) > 250


def test_last_line_format(tmp_path):
    from portbench.tests import tiny

    result, checks = tiny.run("train-b8.ptw-net-c32")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    json.loads(json.dumps(result))
    assert set(result["metrics"]) == {"train_points_per_s",
                                      "train_step_p90_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(checks) == set(manifest.load("train-b8.ptw-net-c32").limits)


def test_layer_reader_of_a_split_metric():
    """``<family>.<part>`` falls back to ``layers/<family>.py``."""
    view = {"trace": {"busy_s": 1.0, "window_s": 4.0}}
    assert manifest.reader("device.idle_share.train")(view) == 75.0
    assert manifest.reader("device.idle_share.predict")(view) == 75.0
    with pytest.raises(FileNotFoundError):
        manifest.reader("no_such_metric")


def test_traffic_kind_found_by_name():
    from portbench import harness

    for name in CELLS:
        kind = manifest.load(name).traffic["kind"]
        assert (manifest.HERE / "kinds" / f"{kind}.py").exists()
    assert callable(harness.make)
