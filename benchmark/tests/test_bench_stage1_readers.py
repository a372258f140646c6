"""The stage-1 cells' readers `forward_ms.train` and
`nerf_chain_roofline.train` on made-up traces and spans, and the bf16
stage-1 cell run tiny on the CPU through the harness."""

import json
import os
import types

import pytest

from benchmark import cells, flops, program_spans, run as brun
from benchmark.tests import tiny

STAGE1 = ["bkg-train", "bkg-train-dp4", "bkg-train-bf16"]
READERS = ["forward_ms.train", "nerf_chain_roofline.train"]


def _config(cell):
    _, cfg, _ = brun.find_cell(brun.load_manifest(), cell)
    return cfg


def _ctx(unit, kernels, work, units=3):
    """A reader's context: the traced units' kernels (base name, full name,
    start us, duration us) and a unit's work."""
    return types.SimpleNamespace(unit=unit, trace=types.SimpleNamespace(kernels=kernels, units=units),
                                 traced_work=work, work=work, peak_flops=flops.PEAK_FLOPS,
                                 roofline_s=flops.roofline_s)


def test_the_readers_are_the_stage1_cells_and_nothing_else():
    manifest = brun.load_manifest()
    listed = {m["name"]: m for m in manifest["per_layer"]}
    for name in READERS:
        assert listed[name]["workloads"] == STAGE1 and listed[name]["moves"] == "train_step_ms"


@pytest.mark.parametrize("name", READERS)
def test_none_outside_a_step(name, monkeypatch):
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda: {"spans": {"step.forward": {"device_ms": 3.0}}, "counters": {}})
    work = cells.TrainBkg.work(types.SimpleNamespace(c=_config("bkg-train")["config"]))
    ctx = _ctx("frame", [("bwd_chain_kernel", "bwd_chain_kernel<float, 256>", 0.0, 100.0)], work)
    assert brun.metric_reader(name)(ctx) is None


@pytest.mark.parametrize("cell", STAGE1)
def test_the_chain_s_work_is_a_third_of_the_step_s_trained_flops(cell):
    cfg = _config(cell)
    work = cells.TrainBkg.work(types.SimpleNamespace(c=cfg["config"]))
    f = work["nerf_mlp"][0]
    dtype = cfg["config"]["compute_dtype"]
    assert work["dtype"] == dtype
    # the model's dX products: as many as the forward's, 2 x MACs
    macs, params = cells._mlp_macs(cfg["config"], "bkg")
    c = cfg["config"]
    samples = c["rays_per_batch"] * (2 * c["samples_per_ray"] + c["importance_samples_per_ray"])
    forward = flops.mlp_work(macs, params, samples, 2 * c["rays_per_batch"], False, False)[0]
    assert f / 3 == pytest.approx(forward, rel=1e-12)
    # 3 traced steps; the chain's kernels 6 ms and 1.5 ms a step; others not counted
    kernels = [("bwd_chain_kernel", "bwd_chain_kernel<bf16>", 0.0, 6000.0),
               ("bwd_ddir_kernel", "bwd_ddir_kernel<bf16>", 0.0, 1500.0),
               ("nerf_mlp_kernel", "nerf_mlp_kernel<bf16>", 0.0, 9000.0),
               ("dw_kernel", "dw_kernel<bf16>", 0.0, 4000.0)] * 3
    got = brun.metric_reader("nerf_chain_roofline.train")(_ctx("step", kernels, work))
    assert got == pytest.approx(100.0 * (forward / flops.PEAK_FLOPS[dtype]) / 7.5e-3, rel=1e-9)
    assert brun.metric_reader("nerf_chain_roofline.train")(_ctx("step", kernels[2:4], work)) is None


def test_forward_ms_reads_the_span_a_step_and_none_without_it(monkeypatch):
    work = cells.TrainBkg.work(types.SimpleNamespace(c=_config("bkg-train-bf16")["config"]))
    read = brun.metric_reader("forward_ms.train")
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda: {"spans": {"step.forward": {"device_ms": 45.0}}, "counters": {}})
    assert read(_ctx("step", [], work)) == pytest.approx(15.0)
    # a program without the span (or a CPU run: no device time) reads nothing
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda: {"spans": {"step.backward": {"device_ms": 45.0}}, "counters": {}})
    assert read(_ctx("step", [], work)) is None
    monkeypatch.setattr(program_spans, "snapshot",
                        lambda: {"spans": {"step.forward": {"device_ms": None}}, "counters": {}})
    assert read(_ctx("step", [], work)) is None


def test_the_bf16_cell_is_bkg_train_in_bf16():
    """The configuration and traffic differ from bkg-train's in the dtype
    and the limits alone."""
    base, bf16 = _config("bkg-train"), _config("bkg-train-bf16")
    assert {k: v for k, v in bf16["config"].items() if base["config"][k] != v} == {
        "compute_dtype": "bfloat16"}
    assert set(bf16["config"]) == set(base["config"]) and bf16["reduced"] == []
    traffic = {}
    for cell in ("bkg-train", "bkg-train-bf16"):
        with open(os.path.join(brun.BENCH, "traffic", cell + ".json")) as f:
            traffic[cell] = json.load(f)
    differ = {k for k in traffic["bkg-train"] if traffic["bkg-train"][k] != traffic["bkg-train-bf16"][k]}
    assert differ <= {"about", "limits"} and set(traffic["bkg-train-bf16"]) == set(traffic["bkg-train"])


def test_a_tiny_bf16_stage1_run_checks_its_steps(capsys):
    """The cell's path on the CPU (the kernels' plain versions in bf16):
    its batches rebuilt exactly and its losses near the f32 reference's.
    Its limits are the card's at the published widths and are not held
    here."""
    result, numbers = tiny.run("bkg-train-bf16")
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert numbers["batch_rays_wrong"] == 0 and numbers["batch_gap"] < 1e-5
    assert numbers["loss_gap"] < 1e-2 and numbers["grad_gap"] < 0.2
