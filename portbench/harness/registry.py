"""Everything a run needs, found by name under `portbench/`, so that a later
cell, configuration or metric is a file added beside these, never an edit:

- `workloads/<cell>.json`: the cell's configuration and traffic names, its
  traffic parameters and why it exists;
- `configs/<config>.json`: the deployment (source, sizes, precision tier,
  layout, interchange, `DeviceStreamDecoder` arguments, the generator and
  the plain reference that serve it, the control, `assumed`, `reduced`);
- `gen/<generator>.py` (`generate(config, traffic, seed)`) and
  `reference/<reference>.py`;
- `metrics/<metric>.py`: one reader per per-layer metric (`LAYER`,
  `SOURCE`, `UNIT`, `MOVES` and `read(readings)`, which returns a number or
  None where it finds nothing to read).
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not _NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def workload(name: str) -> dict:
    """The cell `name` (`workloads/<name>.json`) with `name` set."""
    path = ROOT / "workloads" / f"{_checked(name)}.json"
    if not path.exists():
        raise KeyError(f"no cell {name!r}: {path.name} is not in "
                       f"{path.parent}")
    return {**json.loads(path.read_text()), "name": name}


def config(name: str) -> dict:
    """The configuration `name` (`configs/<name>.json`) with `name` set."""
    path = ROOT / "configs" / f"{_checked(name)}.json"
    return {**json.loads(path.read_text()), "name": name}


def generator(name: str):
    return importlib.import_module(f"portbench.gen.{_checked(name)}")


def reference(name: str):
    return importlib.import_module(f"portbench.reference.{_checked(name)}")


def listed_per_layer(cell: str) -> set:
    """The per-layer metrics that `BENCHMARK.json` (beside `portbench/`)
    lists for `cell`: those whose `workloads` name it or that have none;
    empty where there is no `BENCHMARK.json`."""
    path = ROOT.parent / "BENCHMARK.json"
    if not path.exists():
        return set()
    return {m["name"] for m in json.loads(path.read_text())["per_layer"]
            if cell in m.get("workloads", [cell])}


def metric_readers() -> dict:
    """{metric name: its reader module}, for every `metrics/*.py`."""
    return {path.stem: importlib.import_module(f"portbench.metrics.{path.stem}")
            for path in sorted((ROOT / "metrics").glob("*.py"))
            if path.stem != "__init__"}
