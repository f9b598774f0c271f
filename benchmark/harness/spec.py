"""BENCHMARK.json and the data files it names, found by name.

A cell (an entry of `workloads`) names a configuration, whose file is the
`file` of its entry in `configs`, and a traffic mix, `traffic/<mix>.json`
beside this package, whose `kind` names its driver, `drivers/<kind>.py`.
Its limits of correctness are `limits/<cell>.json`; each per-layer metric
is read by `metrics/<metric>.py`. A later change adds a cell, a mix, a
kind of traffic or a metric by adding files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, bench_dir: Optional[Path] = None) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its data files read."""
    bench_dir = bench_dir or root / BENCH_DIR.name
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    config_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    end_to_end = [m for m in spec["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in reported and _reports(m, name)]
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"], chips=w["chips"],
        config=json.loads((root / config_entry["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench_dir / "limits" / f"{name}.json").read_text()),
        end_to_end=end_to_end, per_layer=per_layer)


def _load(path: Path, name: str):
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[name] = module
    module_spec.loader.exec_module(module)
    return module


def driver(bench_dir: Path, cell: Cell):
    """drivers/<kind>.py of the cell's traffic kind, as a module."""
    kind = cell.traffic["kind"]
    return _load(bench_dir / "drivers" / f"{kind}.py", f"_bench_driver_{kind}")


def metric_reader(bench_dir: Path, name: str) -> Callable:
    """`read` of metrics/<name>.py: Reading -> value or None."""
    return _load(bench_dir / "metrics" / f"{name}.py", f"_bench_metric_{name}").read


def metric_readers(bench_dir: Path, metrics: List[dict]) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(bench_dir, m["name"]) for m in metrics}
