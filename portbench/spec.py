"""Find a cell's pieces by name, from ``BENCHMARK.json`` and the files
under ``portbench/``:

- ``configs``' ``file``: a configuration's sizes (``model`` names its kind
  in ``systems/<model>.py``);
- ``traffic/<mix>.json``: a traffic mix's parameters (``kind`` names its
  generator in ``drives/<kind>.py`` and its work counts in
  ``work/<kind>.py``);
- ``layer_metrics/<metric>.py``: a per-layer metric's reader;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``.

A later cell, mix or metric is a new file and a new entry: no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    system: ModuleType
    drive: ModuleType
    work: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    reader: Callable[[str], ModuleType]

    def sizes(self) -> Dict[str, int]:
        c = self.config
        return {"D": c["output_size"], "k": c["state_size"], "M": c.get("components", 1),
                "rows": c["rows"], "itemsize": 4 if c["dtype"] == "float32" else 8}


class Spec:
    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else HERE.parent
        self.here = self.root / "portbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.here / "limits" / f"{workload}.json").read_text())

    def metrics(self, section: str, workload: str) -> List[dict]:
        """The metrics of ``section`` that the cell reports: those that
        list it under ``workloads``, and those with no list."""
        return [m for m in self.bench[section] if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> ModuleType:
        return load_file(self.here / "layer_metrics" / f"{metric}.py", f"portbench_metric_{metric}")

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        config = self.config(w["config"])
        traffic = self.traffic(w["traffic"])
        return Cell(
            name=name, chips=int(w["chips"]), config=config, traffic=traffic,
            limits=self.limits(name),
            system=importlib.import_module(f"portbench.systems.{config['model']}"),
            drive=importlib.import_module(f"portbench.drives.{traffic['kind']}"),
            work=importlib.import_module(f"portbench.work.{traffic['kind']}"),
            end_to_end=self.metrics("end_to_end", name),
            per_layer=self.metrics("per_layer", name),
            reader=self.reader,
        )


def load_file(path: Path, name: str) -> ModuleType:
    """Import a module from its file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
