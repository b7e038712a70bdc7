"""Finds everything of a cell by the names in `BENCHMARK.json`: the
configuration's file, the traffic mix (`benchmark/traffic/<traffic>.json`),
the driver the configuration names (`benchmark/drivers/<driver>.py`) and
the reader of each per-layer metric. A metric `<base>.<kind>` is read by
`benchmark/metrics/<base>.py`, a function `read(outcome)` that returns a
number or None, in the cells whose driver hands back an outcome of that
kind ("sample", "train"); a metric with no dot in every cell it names.
A later change adds a cell, a configuration, a mix or a metric as new
files and entries, with no edit to a file that is here."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]


def _load_module(path: Path, prefix: str):
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    root: Path
    manifest: dict
    workload: dict
    config_entry: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[dict]:
        return [m for m in self.manifest["per_layer"] if self._applies(m)]

    def driver(self):
        return _load_module(self.root / "benchmark" / "drivers"
                            / f"{self.config['driver']}.py",
                            "benchmark_driver_")

    def readers(self) -> Dict[str, Callable]:
        out = {}
        for m in self.per_layer():
            base, _, kind = m["name"].partition(".")
            read = _load_module(self.root / "benchmark" / "metrics"
                                / f"{base}.py", "benchmark_metric_").read
            out[m["name"]] = _of_kind(read, kind)
        return out


def _of_kind(read: Callable, kind: str) -> Callable:
    """`read`, for outcomes of `kind` only (of any, when it is empty)."""
    return lambda o: read(o) if not kind or o.kind == kind else None


def workloads(root: Path = ROOT) -> List[str]:
    """The names of the cells in `BENCHMARK.json`."""
    return [w["name"] for w in _read_json(root / "BENCHMARK.json")
            ["workloads"]]


def load(workload: str, root: Path = ROOT) -> Cell:
    manifest = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(root, manifest, w, entry, _read_json(root / entry["file"]),
                _read_json(root / "benchmark" / "traffic"
                           / f"{w['traffic']}.json"))
