"""Tiny cells of every traffic kind on the CPU through the program's plain
versions: the result line meets the contract, `correct` holds on sound
runs, and comes out false with the timed path broken underneath; a cell
added from files alone runs."""

import json
import os
import shutil

import pytest

from benchmark import cells, control, run as brun
from benchmark.tests import tiny
from neuman_tpu_torch.trainers import background

CELLS = ["bkg-train", "human-train", "test-view-720p", "canonical-360-720p"]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _line(result, capsys):
    brun.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert err.strip().splitlines()[-1].startswith("check ")
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_prints_a_contract_line(cell, capsys):
    result, numbers = tiny.run(cell, lpips=False)
    line = _line(result, capsys)
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    if cell == "human-train":
        # the limits are set for the card at the cell's widths; at these
        # widths on the CPU the step's gradients sit above them (see PERF.md)
        assert numbers["batch_rays_wrong"] == 0 and numbers["loss_gap"] < 1e-4
    else:
        assert line["correct"] is True
    manifest = brun.load_manifest()
    e2e = {m["name"] for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == e2e
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])


def test_traced_run_reads_its_window(capsys):
    result, _ = tiny.run("bkg-train", trace=1)
    line = _line(result, capsys)
    assert line["correct"] is True and {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: no per-layer metric finds anything to read
    assert line["metrics"] == {}


def _no_update(self, named, grads, state, lr, bad):
    state["count"] = state["count"] + 1


@pytest.mark.parametrize("cell", ["bkg-train", "human-train"])
def test_a_step_that_leaves_the_state_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(background.ScaleByAdam, "step", _no_update)
    result, numbers = tiny.run(cell, lpips=False)
    assert result["correct"] is False and numbers["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell,kind", [("bkg-train", "train_bkg"), ("human-train", "train_human")])
@pytest.mark.parametrize("fault,number", [("half_batch", "loss_gap"), ("alter_batch", "batch_gap")])
def test_a_faulty_batch_is_not_correct(cell, kind, fault, number, monkeypatch):
    """Half of each batch left out (the mean over the rest), or one ray's
    colour altered where the draw produces it."""
    class Faulty(cells.KINDS[kind]):
        def _record_first_steps(self):
            control.FAULTS[fault](self)
            super()._record_first_steps()

    monkeypatch.setitem(cells.KINDS, kind, Faulty)
    result, numbers = tiny.run(cell, lpips=False)
    assert result["correct"] is False and numbers[number] > result["checks"][number]["limit"]


@pytest.mark.parametrize("cell,fn", [("test-view-720p", "render_hybrid_nerf"),
                                     ("canonical-360-720p", "render_smpl_nerf")])
def test_an_altered_frame_is_not_correct(cell, fn, monkeypatch):
    render = getattr(cells.renderer, fn)

    def altered(*a, **k):
        rgb, depth, acc = render(*a, **k)
        rgb = rgb.clone()
        rgb[: rgb.shape[0] // 3] = 1.0 - rgb[: rgb.shape[0] // 3]
        return rgb, depth, acc

    monkeypatch.setattr(cells.renderer, fn, altered)
    result, numbers = tiny.run(cell)
    assert result["correct"] is False and numbers["rgb_max_gap"] > 0.1


def test_a_cell_added_from_files_alone_runs(tmp_path, capsys):
    """A configuration's cell, a traffic mix and a per-layer metric added as
    files and manifest entries, nothing else changed."""
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(brun.BENCH, "configs"), bench / "configs")
    shutil.copytree(os.path.join(brun.BENCH, "traffic"), bench / "traffic")
    shutil.copytree(os.path.join(brun.BENCH, "metrics"), bench / "metrics")
    with open(bench / "traffic" / "bkg-train.json") as f:
        traffic = json.load(f)
    traffic["iteration"] = 5000
    with open(bench / "traffic" / "bkg-early.json", "w") as f:
        json.dump(traffic, f)
    (bench / "metrics" / "traced_steps.py").write_text("def read(ctx):\n    return float(ctx.trace.units)\n")
    manifest = brun.load_manifest()
    manifest["workloads"].append({"name": "bkg-early", "config": "neuman-bkg", "traffic": "bkg-early",
                                  "chips": 1, "why": "stage-1 steps before the anneal"})
    manifest["per_layer"].append({"name": "traced_steps", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "trainers",
                                  "moves": "train_step_ms", "workloads": ["bkg-early"]})
    result, _ = tiny.run("bkg-early", trace=1, manifest=manifest, bench=str(bench))
    line = _line(result, capsys)
    assert KEYS <= set(line) and line["attempted"] >= 1 and set(line["checks"]) == set(traffic["limits"])
    assert line["metrics"]["traced_steps"] == {"value": 3.0, "unit": "steps"}
