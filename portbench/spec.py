"""What the benchmark runs, found by name: BENCHMARK.json's cells and
metrics, a configuration's file, a traffic mix's file, a mode's module and
a metric's reader. Nothing here names a cell, a configuration or a metric:
a later cell adds files and entries and edits none of these."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
TRAFFIC, METRICS = HERE / "traffic", HERE / "metrics"


def benchmark() -> Dict:
    with open(BENCHMARK) as f:
        return json.load(f)


def cell(bench: Dict, workload: str) -> Dict:
    """The workload entry named `workload`, with its configuration entry
    (`config_entry`), its configuration and traffic files read, and its
    metrics split by kind: end_to_end and per_layer, each the entries whose
    `workloads` (if given) name this cell."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = dict(by_name[workload])
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    w["config_entry"] = conf
    with open(ROOT / conf["file"]) as f:
        w["config_file"] = json.load(f)
    with open(TRAFFIC / f"{w['traffic']}.json") as f:
        w["traffic_file"] = json.load(f)

    def mine(ms: List[Dict]) -> List[Dict]:
        return [m for m in ms if workload in m.get("workloads", [workload])]

    w["end_to_end"] = mine(bench["end_to_end"])
    w["per_layer"] = mine(bench["per_layer"])
    return w


def mode(kind: str):
    """The module that runs a traffic kind: portbench/modes/<kind>.py."""
    return importlib.import_module(f"portbench.modes.{kind}")


def reader(metric: str) -> Callable[[Dict], object]:
    """The reader of a metric, `read(record)` in portbench/metrics/<metric>.py
    (a metric's name may hold dots, so the file is loaded by its path)."""
    path = METRICS / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics._{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
