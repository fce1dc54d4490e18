"""What ``BENCHMARK.json`` names, found on disk by name.

A cell names a configuration and a traffic mix; the configuration's
``file`` is ``benchmark/configs/<config>.json``, the mix is
``benchmark/traffic/<traffic>.json`` and each metric's reader is
``benchmark/metrics/<metric>.py``.  A later cell, configuration, mix or
metric adds files and entries; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Metric:
    name: str
    unit: str
    reader: object  # the module: ``read(run) -> float | None``, optional ``SPANS``


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_reader(name: str, bench_dir: Path = BENCH):
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    metrics = [
        [Metric(m["name"], m["unit"], load_reader(m["name"], root / "benchmark")) for m in bench[key] if _applies(m, name)]
        for key in ("end_to_end", "per_layer")
    ]
    return Cell(name, int(w["chips"]), config, traffic, *metrics)
