"""A cell's files, found by the names in ``BENCHMARK.json``.

A configuration is the JSON file its entry names; a traffic mix is
``traffic/<name>.json``; a per-layer metric is ``metrics/<name>.py``, a
module with ``read(run) -> float | None``; the operation a mix names
(``"op"``) is ``ops/<op>.py``.  Adding any of them takes new files and
entries, no edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["ROOT", "BENCH", "Cell", "load_benchmark", "cell", "metric_reader", "op_module"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list      # this cell's end-to-end metric entries
    per_layer: list       # this cell's per-layer metric entries
    chips: int


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of a parsed ``BENCHMARK.json``, its files loaded."""
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = root / BENCH.relative_to(ROOT) / "traffic" / f"{workload['traffic']}.json"
    traffic = json.loads(mix.read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    return Cell(workload, config, traffic, e2e, layer, workload["chips"])


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, metrics_dir: Path | None = None):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = (metrics_dir or BENCH / "metrics") / f"{name}.py"
    return _load(path, f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}").read


def op_module(op: str):
    return importlib.import_module(f"benchmark.ops.{op}")
