"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose ``file`` the
configuration entry gives, and a traffic mix, read from
``benchmark/traffic/<traffic>.json``. Its correctness limits are read from
``benchmark/limits/<cell>.json``, each per-layer metric's reader from
``benchmark/metrics/<metric>.py``, each configuration's family (the code that
builds it on both sides) from ``benchmark/families/<family>.py``, and each
traffic mix's kind (the loop that drives it) from
``benchmark/kinds/<kind>.py``. A later cell, configuration, mix or metric is
new files and new entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file's content
    traffic_name: str
    traffic: dict         # the traffic mix's parameters
    limits: dict          # number -> {"limit": ..., readings}
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    root: Path

    def module(self, folder: str, name: str) -> ModuleType:
        return load_module(self.root / "benchmark" / folder / f"{name}.py")


def load_module(path: Path) -> ModuleType:
    """The module of a file found by name (file names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark._found." + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def resolve(name: str, root: Path = ROOT, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s benchmark with its files read."""
    spec = spec if spec is not None else load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = root / "benchmark" / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else {}
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, root=root)
