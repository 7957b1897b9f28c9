"""What one cell of ``BENCHMARK.json`` names, gathered from its files.

Everything that belongs to one configuration, traffic mix, cell, metric or
kernel count is a file of its own, found by its name:

* ``configs/<config>.json`` — the configuration as it is run (``hparams``,
  the recipe's keys) and the name of its plain reference
  (``reference/<reference>.py``);
* ``traffic/<traffic>.json`` — a traffic mix: its generator ``kind``
  (``traffic/<kind>.py``) and that generator's parameters;
* ``workloads/<cell>.json`` — the cell's own run parameters: the counts
  of the work its calls run (``counts``), the sample of calls that the
  reference checks, the limits of the check;
* ``metrics/<metric>.py`` — one reader a metric, ``read(run)``;
* ``counts/<kernel>.py`` — one count a kernel (operations and bytes from
  the call's shapes), the device symbols that are its time, the program's
  library that holds it and its launch counter.  A cell loads only the
  counts its file names: a count added later changes no other cell.

A later cell, mix, metric or count is a new file and a new entry: no file
here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import one plug-in file, once, under a name of its own."""
    name = f"bench_{prefix}_{path.stem.replace('-', '_').replace('.', '_')}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    params: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    base: Path = HERE
    counts: Dict[str, ModuleType] = field(default_factory=dict)

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: the end-to-end ones untraced, the
        per-layer ones traced; a metric with ``workloads`` only in those
        cells, one without it in every cell that reports what it moves."""
        if not trace:
            return [m for m in self.end_to_end
                    if self.name in m.get("workloads", [self.name])]
        reported = {m["name"] for m in self.metrics(False)}
        return [m for m in self.per_layer
                if self.name in m.get("workloads", [self.name])
                and m["moves"] in reported]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.base / "metrics" / f"{metric}.py", "metric")

    def generator(self) -> ModuleType:
        return load_module(self.base / "traffic" / f"{self.mix['kind']}.py",
                           "traffic")

    def reference(self) -> ModuleType:
        return load_module(
            self.base / "reference" / f"{self.config['reference']}.py",
            "reference")


def load_cell(benchmark: dict, name: str, base: Path = HERE) -> Cell:
    """The cell ``name`` of a parsed ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    config = load_json(base / "configs" / f"{w['config']}.json")
    mix = load_json(base / "traffic" / f"{w['traffic']}.json")
    params = load_json(base / "workloads" / f"{name}.json")
    counts = {c: load_module(base / "counts" / f"{c}.py", "count")
              for c in params["counts"]}
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                params=params, end_to_end=benchmark["end_to_end"],
                per_layer=benchmark["per_layer"], base=base, counts=counts)
