"""The benchmark's data, found by name: ``cells/<cell>.json`` names a
configuration (``configs/<config>.json``) and a mix
(``mixes/<mix>.json``); a configuration names each model's plain
reference (``reference/<name>.py``); ``BENCHMARK.json``, beside the
benchmark's folder, lists the cell's metrics, each read by
``metrics/<name>.py``. Nothing here imports the program.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent


def read_json(root: Path, kind: str, name: str) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict          # cells/<cell>.json
    config: dict        # configs/<config>.json
    mix: dict           # mixes/<mix>.json


def load_cell(name: str, root: Path = HERE) -> Cell:
    spec = read_json(root, "cells", name)
    return Cell(name, spec, read_json(root, "configs", spec["config"]),
                read_json(root, "mixes", spec["mix"]))


def benchmark_entries(cell: Cell, root: Path = HERE) -> dict:
    """The cell's entry and its metrics in ``BENCHMARK.json`` (beside the
    benchmark's folder); the cell file and the entry must agree."""
    with open(root.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == cell.name),
                 None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {cell.name!r}")
    if (entry["config"], entry["traffic"]) != (cell.spec["config"],
                                               cell.spec["mix"]):
        raise ValueError(f"{cell.name}: BENCHMARK.json runs "
                         f"{entry['config']} / {entry['traffic']}, the cell "
                         f"file {cell.spec['config']} / {cell.spec['mix']}")

    def mine(metrics):
        return [m for m in metrics
                if cell.name in m.get("workloads", [cell.name])]
    return {"entry": entry, "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def _load(kind: str, name: str, root: Path):
    """The module ``<root>/<kind>/<name>.py`` (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"servebench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        root / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: Path = HERE) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    return _load("metrics", name, root).read


def load_reference(name: str, root: Path = HERE):
    """The plain reference ``reference/<name>.py``."""
    return _load("reference", name, root)
