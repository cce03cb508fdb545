"""BENCHMARK.json against its contract, and the harness's finding by name."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import spec as spec_mod
from benchmark.harness.runner import run_cell
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for entry in SPEC["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(entry["why"]) <= 200 and 1 <= len(entry["source"]) <= 200
        assert entry["file"].startswith("benchmark/")
        assert (ROOT / entry["file"]).is_file()
        assert NAME.match(entry["name"]) and len(entry["reduced"]) <= 16


def test_names_units_bounds():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        keys = {"name", "unit", "better", "source", "workloads"} | (
            {"bound"} if m in SPEC["end_to_end"] else {"layer", "moves"})
        assert set(m) <= keys and set(m) >= keys - {"workloads"}, m["name"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= 1


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = spec_mod.resolve(cell, ROOT)
    assert c.limits, f"{cell} has no correctness limits"
    assert hasattr(c.module("kinds", c.traffic["kind"]), "Work")
    family = c.module("families", c.config["family"])
    assert family.shapes(c.config)
    for m in c.per_layer:
        assert callable(c.module("metrics", m["name"]).read)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert (ROOT / "benchmark" / "metrics" / f"{metric}.py").is_file()


def test_a_cell_of_new_files_runs(tmp_path):
    """A cell added as files and entries only: a new traffic mix, limits and
    a workload entry beside the tiny ones, found and run on the CPU."""
    root = tiny.make_root(tmp_path)
    traffic = dict(tiny.TRAIN, batch=2, cache_rows=8)
    tiny.write(root / "benchmark/traffic/tiny-train-b2.json", traffic)
    tiny.write(root / "benchmark/limits/tiny-unet-train-b2.json", {"loss": {"limit": 1e-3}})
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-unet-train-b2", "config": "tiny-unet",
                              "traffic": "tiny-train-b2", "chips": 1, "why": "new"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny-unet-train" in m.get("workloads", []):
            m["workloads"].append("tiny-unet-train-b2")
    tiny.write(root / "BENCHMARK.json", spec)
    cell = spec_mod.resolve("tiny-unet-train-b2", root)
    result = run_cell(cell, 2 ** 31 + 5, 0.1, False, "cpu")
    assert result["correct"] and result["attempted"] >= 2
    assert set(result["metrics"]) == {"train_images_per_s", "peak_mem_gib", "setup_s"}
    assert list(result)[-1] == "checks"


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert not _imports(path) & {"jax", "scal_sdt_tpu", "scal_sdt_tpu_torch", "lab"}, path


def test_a_run_loads_no_jax(tmp_path):
    """A whole run in a fresh process leaves no module of JAX, Flax, the JAX
    package or its lab in ``sys.modules`` (top-level names compared whole)."""
    root = tiny.make_root(tmp_path)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness.spec import resolve\n"
        "from benchmark.harness.runner import run_cell\n"
        "from benchmark.run import forbidden_modules\n"
        "for cell in ('tiny-unet-train', 'tiny-mmdit-train', 'tiny-unet-sample'):\n"
        "    run_cell(resolve(cell, __import__('pathlib').Path(%r)), 7, 0.05, False, 'cpu')\n"
        "print(forbidden_modules())\n" % (str(ROOT), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "scal_sdt_tpu_torch_x", sys)
    assert "scal_sdt_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in forbidden_modules()
