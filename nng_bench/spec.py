"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); each per-layer metric is a reader in
``metrics/<name>.py``. A name with no file is an error, never a default.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def resolve(bench: dict, workload: str) -> Cell:
    """The cell ``workload`` with its configuration, traffic and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    path = Path(entry["file"])
    if path.parent.name != "configs" or not (HERE / "configs"
                                             / path.name).is_file():
        raise FileNotFoundError(f"configuration file {entry['file']!r} is "
                                "not in the benchmark's configs/")
    config = _read_json("configs", path.stem)
    config["name"] = w["config"]
    traffic = _read_json("traffic", w["traffic"])
    traffic["name"] = w["traffic"]
    return Cell(workload, config, traffic, int(w["chips"]),
                [m for m in bench["end_to_end"] if _covers(m, workload)],
                [m for m in bench["per_layer"] if _covers(m, workload)])


def reader(name: str):
    """The ``read(record)`` function of per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}: "
                                f"{path}")
    spec = importlib.util.spec_from_file_location(
        f"nng_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
