"""Finds what belongs to a cell by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), the driver its configuration names
(``drivers/<driver>.py``) and each per-layer metric's reader
(``metrics/<metric>.py``). Adding a cell, a configuration, a traffic mix
or a metric is adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files of the benchmark's folder."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.data = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def driver(self, name: str) -> ModuleType:
        return _load(self.dir / "drivers" / f"{name}.py", f"benchmark_driver_{name}")

    def metric(self, name: str) -> ModuleType:
        return _load(self.dir / "metrics" / f"{name}.py", f"benchmark_metric_{name}")

    def metrics(self, kind: str, cell: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
        those with no ``workloads`` key, and those that list it."""
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]


def _load(path: Path, modname: str) -> ModuleType:
    """A module from its file; names may hold dots (``mfu.neural.py``)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    modname = modname.replace(".", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod   # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod
