"""Everything a run needs, found by name from ``BENCHMARK.json``.

- ``BENCHMARK.json`` at the checkout's root: the cells, the metrics;
- ``benchmark/configs/<config>.json``: a model configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: a traffic mix's parameters, with the
  ``runner`` (``benchmark/runners/<runner>.py``) that runs it;
- ``benchmark/workloads/<cell>.json``: the cell's correctness limits;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.

A later change adds a configuration, a mix, a cell or a metric as new files
and new manifest entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """Import the file at ``path`` as a module named ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict            # the cell file: correctness limits and their readings
    chips: int
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports
    root: str = ROOT        # the checkout it was read from


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and metrics."""
    manifest = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = os.path.join(root, "benchmark")
    config = read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = read_json(os.path.join(bench, "traffic", f"{w['traffic']}.json"))
    limits = read_json(os.path.join(bench, "workloads", f"{name}.json"))
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name, names)]
    return Cell(name, config, traffic, limits, int(w["chips"]), e2e, per_layer, root)


def runner(traffic: dict, root: str = ROOT) -> ModuleType:
    kind = traffic["runner"]
    return load_module(os.path.join(root, "benchmark", "runners", f"{kind}.py"),
                       f"benchmark_runner_{kind.replace('.', '_')}")


def readers(metrics: List[dict], root: str = ROOT) -> Dict[str, ModuleType]:
    """metric name -> its reader module (``benchmark/metrics/<name>.py``)."""
    return {m["name"]: load_module(os.path.join(root, "benchmark", "metrics",
                                                f"{m['name']}.py"),
                                   "benchmark_metric_" + m["name"].replace(".", "_"))
            for m in metrics}
