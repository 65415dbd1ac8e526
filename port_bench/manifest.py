"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's
entry names its file; a traffic mix is ``traffic/<name>.json``; a
per-layer metric's reader is ``metrics/<name>.py`` with a function
``read(context)`` that returns the metric's value, or None when the run
gave it nothing to read.  An end-to-end or per-layer metric applies to
the cells its ``workloads`` list names, or to every cell without one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, data: dict, root: Path = ROOT):
        self.data, self.root = data, Path(root)
        self.cells = {w["name"]: w for w in data["workloads"]}
        self.configs = {c["name"]: c for c in data["configs"]}

    @classmethod
    def load(cls, root: Path = ROOT) -> "Manifest":
        with open(Path(root) / "BENCHMARK.json") as f:
            return cls(json.load(f), root)

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        with open(self.root / self.configs[name]["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(HERE / "traffic" / f"{name}.json") as f:
            return json.load(f)

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]


def reader(name: str) -> Callable[[dict], object]:
    """``read`` of ``metrics/<name>.py`` (a name may hold dots, so the file
    is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
