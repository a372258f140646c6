"""The gathering cell (`gathering-720p`, kind `render_gathering` from
benchmark/kinds/) shrunk for the CPU: it runs through run.py traced and
through control.readings, reads its new per-layer metrics, and comes out
not correct when one actor's net is left out of the program's frame."""

import ast
import json
import os

from benchmark import cells, control, run as brun
from benchmark.tests import tiny

CELL = "gathering-720p"


def _line(result, capsys):
    brun.emit(result)
    out, _ = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1])


def test_the_kind_is_a_file_and_the_reference_imports_nothing_of_the_program():
    kind = brun.runner_class("render_gathering")
    assert kind.__module__ == "benchmark_kind_render_gathering" and "render_gathering" not in cells.KINDS
    path = os.path.join(brun.BENCH, "reference", "gathering.py")
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops <= {"benchmark", "torch"}


def test_a_traced_tiny_run_and_its_control(capsys, monkeypatch):
    calls = []
    multi = cells.renderer.render_hybrid_nerf_multi_persons

    def counted(*a, **k):
        calls.append(len(a[4]))
        return multi(*a, **k)

    monkeypatch.setattr(cells.renderer, "render_hybrid_nerf_multi_persons", counted)
    result, _ = tiny.run(CELL, trace=1)
    line = _line(result, capsys)
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == {"rgb_mean_gap"}
    # every frame (warm-up, window, traced) renders the three actors
    assert calls == [3] * (1 + line["attempted"] + 1)
    metrics = line["metrics"]
    assert "merge_ms.render" not in metrics  # a span's device time: no CUDA here
    assert 0.0 < metrics["placeholder_pct.render"]["value"] < 100.0
    assert metrics["hit_rays.render"]["value"] > 0

    _, c, cfg, small = tiny.tiny(CELL)
    prog, ctrl = control.readings(c, cfg, small, 5, 0.3, "none", device="cpu")
    assert prog["rgb_mean_gap"] <= small["limits"]["rgb_mean_gap"] and set(ctrl) == set(prog)


def test_an_actor_left_out_is_not_correct(monkeypatch):
    multi = cells.renderer.render_hybrid_nerf_multi_persons

    def two_of_three(bkg_spec, bkg_model, cap, specs, models, verts, faces, ts, device, topologies=None,
                     **kw):
        """The frame without the first actor, whom every camera sees."""
        return multi(bkg_spec, bkg_model, cap, specs[1:], models[1:], verts[1:], faces[1:], ts[1:], device,
                     topologies=topologies[1:], **kw)

    monkeypatch.setattr(cells.renderer, "render_hybrid_nerf_multi_persons", two_of_three)
    result, numbers = tiny.run(CELL)
    assert result["correct"] is False
    assert numbers["rgb_mean_gap"] > result["checks"]["rgb_mean_gap"]["limit"]
