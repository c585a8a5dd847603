"""``BENCHMARK.json`` and the files it names, found by name alone: a
configuration's file is its entry's ``file``, a traffic mix is
``port_bench/traffic/<traffic>.json`` and a per-layer metric's reader is
``port_bench/layer_metrics/<metric>.py`` (its ``read(ctx)`` returns the
number, or None where the run had nothing to read). A traffic file's
``kind`` and a configuration's ``family`` and ``reference`` name modules
of ``port_bench/kinds``, ``port_bench/models`` and
``port_bench/reference``. Adding a cell, a configuration, a metric, a kind
or a family adds files and entries and edits none."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]
TRAFFIC_DIR = Path("port_bench") / "traffic"
METRICS_DIR = Path(__file__).resolve().parent / "layer_metrics"


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its
    configuration, traffic mix and metrics."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / TRAFFIC_DIR / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def reader(metric: str, directory: Path = METRICS_DIR) -> Callable:
    """The ``read`` function of the per-layer metric ``metric``."""
    path = Path(directory) / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench.layer_metrics." + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
