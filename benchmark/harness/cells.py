"""Find a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything a
cell needs sits in a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the configuration (its file is named in
  ``BENCHMARK.json``'s ``configs``);
- ``traffic/<traffic>.json``: the traffic mix's parameters and the name
  of the driver that plays it;
- ``drivers/<driver>.py``: the driver (``run(run) -> Result``);
- ``checks/<cell>.json``: the limits of the numbers the cell compares;
- ``metrics/<metric>.py``: a per-layer metric's reader
  (``read(ctx) -> float or None``).

A later cell, configuration or metric adds files and entries; no file
here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]
    here: Path  # the checkout's benchmark folder


def _reports(metric: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def load(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    here = root / "benchmark"
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "checks" / f"{name}.json").read_text()
                        )["limits"]
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if _reports(m, name, e2e)]
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer,
                units, here)


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(here: Path, metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py`` under ``here`` (a
    metric's name may hold dots, so the file is loaded by its path)."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
