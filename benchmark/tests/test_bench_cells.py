"""Tiny cells of every traffic kind on the CPU through the program's plain
versions: the result line meets the contract, `correct` holds on sound
runs, and comes out false with the timed path broken underneath; a cell,
and a kind of traffic, added from files alone run."""

import json
import os
import shutil

import pytest

from benchmark import cells, control, run as brun
from benchmark.tests import tiny
from neuman_tpu_torch.trainers import background

CELLS = ["bkg-train", "human-train", "test-view-720p", "canonical-360-720p"]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
# the per-layer metrics whose readers read without CUDA: the program's spans
# on the host's clock and its counters; the others read the device's trace,
# CUDA events or CUDA's peak memory
HOST_READABLE = {"readback_wait_ms.train", "face_pileup.train", "hit_sync_ms.render", "hit_rays.render"}


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
    # no device on the CPU: only the readers that need no CUDA find something to read
    per_layer = {m["name"]: m for m in brun.load_manifest()["per_layer"]
                 if "bkg-train" in m.get("workloads", ["bkg-train"])}
    assert set(line["metrics"]) == HOST_READABLE & set(per_layer)
    assert all(per_layer[k]["source"] != "device_trace" for k in line["metrics"])


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


MULTI_ONE = '''"""render_multi_one: the test view's frames through the multi-person
renderer, with the cell's one body as the only actor."""

from benchmark import cells
from neuman_tpu_torch.render import renderer


class Runner(cells.RenderHybrid):
    def _frame(self, i):
        c, f = self.c, self.frame_ids[i]
        return renderer.render_hybrid_nerf_multi_persons(
            self.spec, self.model, self.caps[i], [self.spec], [self.model], [self.fr["verts"][f]],
            [self.faces], [self.fr["ts"][f]], self.device, rays_per_batch=c["render_rays_per_batch"],
            samples_per_ray=c["samples_per_ray"], importance_samples_per_ray=c["importance_samples_per_ray"],
            geo_threshold=self.geo, knn_k=c["knn_k"], knn_stride=c["knn_stride"])[0]
'''


def test_a_kind_added_from_files_alone_runs(tmp_path, capsys, monkeypatch):
    """A kind of traffic added as benchmark/kinds/<kind>.py, with a traffic
    mix of that kind and its cell as files and manifest entries, nothing else
    changed: it runs through run.py and control.py. With one actor the
    multi-person renderer takes the same samples and the same merge as
    render_hybrid_nerf, so the hybrid reference and its limit hold."""
    bench = tmp_path / "benchmark"
    for folder in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(brun.BENCH, folder), bench / folder)
    (bench / "kinds").mkdir()
    (bench / "kinds" / "render_multi_one.py").write_text(MULTI_ONE)
    with open(bench / "traffic" / "test-view-720p.json") as f:
        traffic = json.load(f)
    traffic["kind"] = "render_multi_one"
    with open(bench / "traffic" / "test-view-multi-one.json", "w") as f:
        json.dump(traffic, f)
    manifest = brun.load_manifest()
    manifest["workloads"].append({"name": "test-view-multi-one", "config": "neuman-human",
                                  "traffic": "test-view-multi-one", "chips": 1,
                                  "why": "the test view through the multi-person renderer, one actor"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "test-view-720p" in m.get("workloads", []):
            m["workloads"].append("test-view-multi-one")
    # every frame goes through the file's runner: the one-person renderer is never called
    calls = []
    multi = cells.renderer.render_hybrid_nerf_multi_persons

    def counted(*a, **k):
        calls.append(1)
        return multi(*a, **k)

    def refused(*a, **k):
        raise AssertionError("render_hybrid_nerf called")

    monkeypatch.setattr(cells.renderer, "render_hybrid_nerf_multi_persons", counted)
    monkeypatch.setattr(cells.renderer, "render_hybrid_nerf", refused)
    kind = brun.runner_class("render_multi_one", str(bench))
    assert issubclass(kind, cells.RenderHybrid) and kind.__module__ == "benchmark_kind_render_multi_one"

    result, _ = tiny.run("test-view-multi-one", trace=1, manifest=manifest, bench=str(bench))
    line = _line(result, capsys)
    assert KEYS <= set(line) and line["correct"] is True and set(line["checks"]) == set(traffic["limits"])
    # the warm-up frame, the window's and the traced ones
    assert len(calls) == 1 + line["attempted"] + traffic["trace_units"]
    assert "hit_rays.render" in line["metrics"]

    _, c, cfg, small = tiny.tiny("test-view-multi-one", manifest=manifest, bench=str(bench))
    prog, ctrl = control.readings(c, cfg, small, 5, 0.3, "none", device="cpu", bench=str(bench))
    assert prog["rgb_mean_gap"] <= small["limits"]["rgb_mean_gap"] and set(ctrl) == set(prog)


@pytest.mark.parametrize("case", ["no_file", "named_after_a_built_in",
                                  "train_bkg", "train_human", "render_hybrid", "render_canonical"])
def test_a_kind_is_built_in_or_added_and_never_replaced(case, tmp_path, capsys):
    """A built-in kind resolves to `cells.KINDS[kind]` itself; a kind with
    no file, or a file named after a built-in kind, stops the run before
    any set-up, naming the path, with no result line."""
    bench = tmp_path / "benchmark"
    (bench / "kinds").mkdir(parents=True)
    if case in cells.KINDS:
        assert brun.runner_class(case) is cells.KINDS[case]
        assert brun.runner_class(case, str(bench)) is cells.KINDS[case]
        return
    cell, kind = ("test-view-720p", "no_such_kind") if case == "no_file" else ("bkg-train", "train_bkg")
    path = bench / "kinds" / f"{kind}.py"
    if case == "named_after_a_built_in":
        path.write_text("from benchmark import cells\n\n\nclass Runner(cells.TrainBkg):\n    pass\n")
    manifest, c, cfg, traffic = tiny.tiny(cell)
    traffic["kind"] = kind
    args = brun.parse_args(["--workload", cell, "--seed", "3", "--seconds", "0.3", "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        brun.run(args, manifest, c, cfg, traffic, str(bench))
    assert str(path) in str(e.value) and repr(kind) in str(e.value)
    assert capsys.readouterr().out == ""
