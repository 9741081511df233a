"""``BENCHMARK.json`` and the files the harness finds by name in it:
``configs/<config>.json`` and its architecture's ``arch/<arch>.py``
(``arch.load``), ``traffic/<traffic>.json``, ``limits/<cell>.json``,
``layers/<metric>.py`` (or, for a metric split by what it moves,
``<family>.<part>``, the family's ``layers/<family>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from portbench import arch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and metrics."""

    def __init__(self, bench: dict, name: str):
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.chips = entry["chips"]
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        self.config = _json(ROOT / conf["file"])
        arch.load(self.config["model"])  # an unknown one fails before a run
        self.traffic_name = entry["traffic"]
        self.traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


def load(name: str) -> Cell:
    return Cell(_json(ROOT / "BENCHMARK.json"), name)


def reader(metric: str):
    """The ``read(view)`` function of ``layers/<metric>.py``, else of
    ``layers/<family>.py`` where the metric is ``<family>.<part>``."""
    path = HERE / "layers" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = HERE / "layers" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_layer_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
