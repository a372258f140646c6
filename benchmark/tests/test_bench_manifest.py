"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, every file it names, and the import rule."""

import ast
import json
import os
import re

import pytest

from benchmark import run as brun

ROOT = brun.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return brun.load_manifest()


def test_manifest_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                             "per_layer"}
    assert manifest["paths"] == ["benchmark"] and 1 <= manifest["run_seconds"] <= 51
    assert len(manifest["command"]) <= 32 and all(not w.startswith("/") for w in manifest["command"])
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(brun.BENCH, "traffic", w["traffic"] + ".json"))
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert os.path.isfile(os.path.join(brun.BENCH, "metrics", m["name"] + ".py"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_enough(manifest):
    """setup_s, another end-to-end metric and a per-layer metric in every
    cell; each per-layer metric's cells report the metric it moves."""
    cells = [w["name"] for w in manifest["workloads"]]
    has = lambda m, c: c in m.get("workloads", cells)
    for c in cells:
        e2e = [m["name"] for m in manifest["end_to_end"] if has(m, c)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m, c) for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        moved = next(e for e in manifest["end_to_end"] if e["name"] == m["moves"])
        assert all(has(moved, c) for c in m["workloads"])


def test_configuration_files(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert cfg["config"]["nerf_width"] == 256 and cfg["config"]["nerf_depth"] == 8


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(brun.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(brun.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(brun.BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert tops <= {"benchmark", "torch", "numpy", "contextlib", "math"}, f


def test_forbidden_modules_compares_whole_top_level_names():
    assert brun.forbidden_modules(["neuman_tpu_torch", "neuman_tpu_torch.ops", "torch"]) == []
    assert brun.forbidden_modules(["neuman_tpu.models", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "neuman_tpu"]
