"""The port's spans and counters (neuman_tpu_torch/utils/tracing.py) on the
CPU: off without a profiler, recorded under one; the benchmark's traced
tiny runs read them, and the harness's own span names stay its own."""

import json
import os
import re
import time

import pytest
import torch

from benchmark import cells
from benchmark import trace as btrace
from benchmark.tests import tiny
from neuman_tpu_torch.ops import kernels
from neuman_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = set(btrace.SPANS) | {"host"}


@pytest.fixture
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_off_records_nothing_and_int_counters_still_add(fresh, monkeypatch):
    def no_record_function(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    before = tracing.total("test.ints")
    assert not tracing.enabled()
    assert tracing.span("test.a") is tracing.span("test.b")  # one shared no-op
    with tracing.span("test.a"):
        tracing.count("test.ints", 3)
        tracing.count("test.tensor", torch.tensor(5))
    assert tracing.total("test.ints") == before + 3
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_profiled_spans_nest_and_counters_sum(fresh, tmp_path):
    with _profiled() as prof:
        assert tracing.enabled()
        with tracing.span("test.outer"):
            time.sleep(0.01)
            for _ in range(2):
                with tracing.span("test.inner"):
                    time.sleep(0.005)
                    tracing.count("test.tensor", torch.tensor(4))
            tracing.count("test.ints", 2)
    snap = tracing.snapshot()
    outer, inner = snap["spans"]["test.outer"], snap["spans"]["test.inner"]
    assert (outer["calls"], inner["calls"]) == (1, 2)
    assert outer["host_ms"] >= 20.0 and inner["host_ms"] >= 10.0
    assert outer["self_host_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"])
    assert inner["self_host_ms"] == pytest.approx(inner["host_ms"])
    assert outer["device_ms"] is None  # no CUDA
    assert snap["counters"] == {"test.tensor": 8.0, "test.ints": 2}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"test.outer", "test.inner"} <= names
    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_launch_counters_are_read_from_the_registry():
    before = kernels.launches()
    tracing.count("launches.nerf_mlp", 2)
    tracing.count("launches.bucketed_knn")
    counts = kernels.launches(before)
    assert counts == {k: {"nerf_mlp": 2, "bucketed_knn": 1}.get(k, 0) for k in kernels.KERNELS}


def test_program_span_names_are_dotted_and_not_the_harness_s():
    names = set()
    for base, _, files in os.walk(os.path.join(REPO, "neuman_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    names |= set(re.findall(r'tracing\.(?:span|count)\("([^"]+)"', fh.read()))
    assert {"step.backward", "step.optimizer", "step.readback", "human.warp", "human.lpips",
            "warp.face_pileup", "render.hit_test", "render.hit_sync", "render.human_branch",
            "render.hit_rays"} <= names
    assert all("." in n for n in names) and not names & HARNESS


@pytest.fixture(scope="module")
def traced_runs():
    """Traced tiny CPU runs: {cell: (result line, the traced frames' hit
    count by the harness's f32 check)}."""
    seen = {}
    orig = cells.RenderRunner.trace_hits

    def trace_hits(self):
        seen["hits"] = orig(self)
        return seen["hits"]

    cells.RenderRunner.trace_hits = trace_hits
    out = {}
    try:
        for cell, kw in (("human-train", {"lpips": False}), ("test-view-720p", {}),
                         ("canonical-360-720p", {})):
            tracing.reset()
            seen.pop("hits", None)
            result, _ = tiny.run(cell, trace=1, **kw)
            out[cell] = result, seen.get("hits")
    finally:
        cells.RenderRunner.trace_hits = orig
        tracing.reset()
    return out


@pytest.mark.parametrize("cell,present,absent", [
    ("human-train", {"face_pileup.train", "readback_wait_ms.train"},
     {"backward_ms.train", "adam_ms.train", "warp_ms.train", "lpips_ms.train"}),
    ("canonical-360-720p", {"hit_rays.render", "hit_sync_ms.render"},
     {"hit_test_ms.render", "human_branch_ms.render"}),
    ("test-view-720p", {"hit_rays.render", "hit_sync_ms.render"},
     {"hit_test_ms.render", "human_branch_ms.render"}),
])
def test_traced_tiny_run_reads_the_program_s_spans(traced_runs, cell, present, absent):
    """Host clocks and counters are read on the CPU; device times are
    absent there, not 0."""
    result, hits = traced_runs[cell]
    assert result["correct"] is True
    metrics = result["metrics"]
    assert present <= set(metrics) and not absent & set(metrics)
    assert all(metrics[m]["value"] >= 0 for m in present)
    if cell == "human-train":
        assert metrics["face_pileup.train"]["value"] >= 1
    else:
        # the program's hit test against the harness's f32 one on the traced frames
        assert hits is not None and hits[1] > 0
        assert abs(metrics["hit_rays.render"]["value"] - hits[1]) <= max(2, 0.005 * hits[1])


@pytest.mark.parametrize("cell", ["human-train", "test-view-720p"])
def test_traced_breakdown_names_gaps_by_the_harness_spans(traced_runs, cell):
    gaps = traced_runs[cell][0]["breakdown"]["idle_gaps"]
    assert gaps and {name for name, _ in gaps} <= HARNESS
