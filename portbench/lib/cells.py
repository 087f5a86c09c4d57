"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root names each workload's configuration and traffic mix; their files are
``portbench/configs/<config>.json`` and ``portbench/traffic/<traffic>.json``,
the limits of the workload's ``correct`` are
``portbench/limits/<workload>.json``, and each per-layer metric's reader is
``portbench/metrics/<name>.py``. A traffic file's ``kind`` names the driver
that runs it, ``portbench/lib/<kind>.py``: its ``drive(cell, dev,
t_start)`` runs the cell and its ``numbers(run)`` gives the numbers that
the limits hold. Adding a cell, a configuration, a mix, a kind of traffic
or a metric adds files and entries; no existing file changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    """One run of one workload."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    fault: Optional[str] = None   # planted faults, "+"-joined (tests, controls)
    sizes: dict = field(default_factory=dict)  # test-only size overrides

    def faults(self) -> set:
        return set(self.fault.split("+")) if self.fault else set()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its files."""
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{w['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")

    def reported(metric):
        return name in metric.get("workloads", [name])

    end_to_end = [m for m in bench["end_to_end"] if reported(m)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and reported(m)]
    return Cell(name, w, config, traffic, limits, end_to_end, per_layer,
                root=root)


_LOADED: dict = {}


def _load(path: Path, module: str):
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(module, path)
        loaded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded)
        _LOADED[path] = loaded
    return _LOADED[path]


def _module_name(prefix: str, name: str) -> str:
    return f"portbench_{prefix}_" + name.replace(".", "_").replace("-", "_")


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``."""
    return _load(root / "portbench" / "metrics" / f"{metric}.py",
                 _module_name("metric", metric)).read


def driver(kind: str, root: Path = ROOT):
    """The module ``portbench/lib/<kind>.py``: ``drive`` and ``numbers``."""
    return _load(root / "portbench" / "lib" / f"{kind}.py",
                 _module_name("driver", kind))
