"""What a run is asked to do, found by name: the workload's entry in
``BENCHMARK.json``, its configuration file, its traffic mix
(``benchmark/traffic/<traffic>.json``), its cell file with the comparison's
limits (``benchmark/cells/<workload>.json``) and the readers of its
per-layer metrics (``benchmark/metrics/<metric>.py``).  A configuration, a
traffic mix, a cell or a metric is added by adding its files and its entry
in ``BENCHMARK.json``; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

#: the benchmark's folder; the repository's root is its parent
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable = None  # per-layer metrics: the reader of its file


@dataclass
class Workload:
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    cell: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reader(bench_dir: Path, name: str) -> Callable:
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"okbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: Dict, workload: str, reported=()) -> bool:
    """A metric with a ``workloads`` list is reported in those cells; a
    per-layer one without it in every cell that reports the end-to-end
    metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load(name: str, manifest: Path = ROOT / "BENCHMARK.json", bench_dir: Path = BENCH_DIR) -> Workload:
    """The workload ``name`` of ``manifest``; its configuration file is a
    path from the manifest's folder, the rest is found in ``bench_dir``."""
    bench = _load_json(manifest)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {manifest.name}: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(manifest.parent / configs[entry["config"]]["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    cell = _load_json(bench_dir / "cells" / f"{name}.json")
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"] if _applies(m, name)]
    names = [m.name for m in e2e]
    per_layer = [Metric(m["name"], m["unit"], _reader(bench_dir, m["name"])) for m in bench["per_layer"]
                 if _applies(m, name, names)]
    return Workload(name, entry, config, traffic, cell, e2e, per_layer)
