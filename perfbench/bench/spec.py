"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells; each
cell names a configuration (its ``file``) and a traffic mix
(``perfbench/traffic/<name>.json``).  A configuration's ``model`` names
its adapter, ``perfbench/models/<model>.py``; every metric is a reader,
``perfbench/metrics/<name>.py``; a cell's limits of correctness are in
``perfbench/limits/<cell>.json``.  Adding a cell, a mix, a configuration
or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """The benchmark as a checkout at ``root`` defines it."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = _json(self.root / "BENCHMARK.json")

    def cells(self) -> List[str]:
        return [w["name"] for w in self.bench["workloads"]]

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {self.cells()})")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return _json(self.root / "perfbench" / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return _json(self.root / "perfbench" / "limits"
                     / f"{cell}.json")["limits"]

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The metrics a run of ``cell`` reports: the per-layer ones with
        ``trace``, else the end-to-end ones; an entry with a
        ``workloads`` list only in those cells."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        """The metric's reader (its file name may hold dots)."""
        return self._load("metrics", metric)

    def model(self, name: str) -> ModuleType:
        """A configuration's model adapter."""
        return self._load("models", name)

    def _load(self, folder: str, name: str) -> ModuleType:
        path = self.root / "perfbench" / folder / f"{name}.py"
        found = importlib.util.spec_from_file_location(
            f"perfbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
            path)
        module = importlib.util.module_from_spec(found)
        found.loader.exec_module(module)
        return module

