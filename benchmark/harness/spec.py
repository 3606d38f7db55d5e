"""Find a cell and everything it names, by name, from files of their own.

``BENCHMARK.json`` (at the root of the checkout) lists the cells. A cell
names a configuration (``configs/<config>.json``), a traffic mix
(``traffic/<traffic>.json``, which names its driver,
``drivers/<driver>.py``) and, through the metric lists, the readers in
``metrics/<metric>.py``. Adding any of them is adding files: nothing here
lists them.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: str | None = None
    workloads: List[str] | None = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench_dir: str


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """A module from a file, by path: names such as ``mfu.train`` are no
    Python identifiers, and a later PR only adds files."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics(entries) -> List[Metric]:
    return [Metric(name=e["name"], unit=e["unit"], moves=e.get("moves"),
                   workloads=e.get("workloads")) for e in entries]


def load_cell(workload: str, root: str, bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its
    configuration, its traffic and the metrics it reports."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    e2e_all = _metrics(bench["end_to_end"])
    e2e = [m for m in e2e_all
           if m.workloads is None or workload in m.workloads]
    reported = {m.name for m in e2e}
    layer = [m for m in _metrics(bench["per_layer"])
             if (workload in m.workloads if m.workloads is not None
                 else m.moves in reported)]
    return Cell(name=workload, chips=int(w["chips"]),
                config_name=w["config"], traffic_name=w["traffic"],
                config=config, traffic=traffic, end_to_end=e2e,
                per_layer=layer, bench_dir=bench_dir)


def driver(cell: Cell) -> ModuleType:
    """The general generator the traffic mix names (``drivers/<x>.py``)."""
    return importlib.import_module("drivers." + cell.traffic["driver"])


def reader(cell: Cell, metric: str) -> ModuleType:
    return load_module(os.path.join(cell.bench_dir, "metrics",
                                    metric + ".py"),
                       "bench_metric_" + metric.replace(".", "_"))

