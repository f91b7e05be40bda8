"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

A cell (one entry of ``workloads``) names a configuration and a traffic
mix. Everything the harness needs for it is found by name:

- ``configs[].file``: the configuration as it is run, with the
  benchmark's notes under ``"bench"`` (its source, the input shapes);
- ``traffic/<traffic>.json``: the mix's parameters; its ``"generator"``
  names the module ``traffic/<generator>.py`` that drives it;
- ``metrics/<name>.py``: the reader of each per-layer metric;
- ``checks/<workload>.json``: the limit of every number the correctness
  check compares, with the readings it was set from.

A new cell, mix or metric is new files and new entries: no file that is
there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    config_name: str
    traffic: Dict[str, Any]
    traffic_name: str
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, float]

    @property
    def input_shapes(self) -> Dict[str, List[int]]:
        return self.config["bench"]["input_shapes"]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises
    ``KeyError`` for an unknown name, ``FileNotFoundError`` for a missing
    file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload)]
    limits = json.loads(
        (BENCH_DIR / "checks" / f"{workload}.json").read_text())["limits"]
    return Cell(workload, int(w["chips"]), config, w["config"], traffic,
                w["traffic"], e2e, per_layer, limits)


def load_module(path: Path) -> ModuleType:
    """Imports the file ``path`` as a module of its own (the names of
    metric readers hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(cell: Cell) -> ModuleType:
    return load_module(BENCH_DIR / "traffic"
                       / f"{cell.traffic['generator']}.py")


def reader(metric_name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{metric_name}.py")
