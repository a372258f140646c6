"""The port's command line (`python -m neuman_tpu_torch.train`) vs the JAX
package's train.py, on one module-scoped `tests/fixtures.build_synthetic_scene`.

`neuman_tpu_torch.train.main(argv, device="cpu")` runs in-process with the
TINY flags of tests/test_cli.py (depth 2, width 32, 8 + 8 samples): stage 1
for 2 steps, then stage 2 for 2 steps on stage 1's background. The JAX
command line's stage 1 runs once, in-process, for the checkpoint it
leaves. Where a test compares what each command line hands its trainer
(views, thresholds, alignments, loaded nets), the trainer class is
replaced by one that records its arguments and does not train.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import train as jtrain
from neuman_tpu.models import nerf as jnerf
from neuman_tpu.options import config as jconfig
from neuman_tpu.trainers import checkpoint as jckpt
from neuman_tpu_torch import convert
from neuman_tpu_torch import train as ttrain
from neuman_tpu_torch.ops.kernels.nerf_mlp import nerf_mlp_plain
from neuman_tpu_torch.options import config as tconfig
from neuman_tpu_torch.trainers import human as thuman
from neuman_tpu_torch.utils import png
from tests.fixtures import build_synthetic_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--nerf_depth", "2", "--nerf_width", "32", "--pos_N_freqs", "4", "--pos_max_freq", "3",
        "--dir_N_freqs", "2", "--dir_max_freq", "1", "--samples_per_ray", "8",
        "--importance_samples_per_ray", "8", "--max_iter", "2", "--valid_iter", "10",
        "--dilation", "2"]
BKG = ["--train_mode", "bkg", "--rays_per_batch", "128"]
HUMAN = ["--train_mode", "smpl_and_offset", "--rays_per_batch", "64", "--penalize_lpips", "0",
         "--geo_threshold", "0.3"]
# the JAX config resolves these from its backend (False on the CPU); the
# port keeps them as given (None: the kernels)
BACKEND_FIELDS = ("use_pallas", "pe_recurrence")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """(scene dir, out dir); NEUMAN_DATA_ROOT at the scene's body model for
    the module, the caller's value back after."""
    before = os.environ.get("NEUMAN_DATA_ROOT")
    root = tmp_path_factory.mktemp("torch_cli")
    scene_dir = build_synthetic_scene(root)
    yield scene_dir, str(root / "out")
    if before is None:
        os.environ.pop("NEUMAN_DATA_ROOT", None)
    else:
        os.environ["NEUMAN_DATA_ROOT"] = before


def _argv(workdir, mode, name, *extra):
    scene_dir, out = workdir
    return (BKG if mode == "bkg" else HUMAN) + ["--scene_dir", scene_dir, "--out_dir", out,
                                                "--name", name] + TINY + list(extra)


@pytest.fixture(scope="module")
def port_runs(workdir):
    """The port's stage 1 and stage 2 (on stage 1's background): trainers."""
    bkg = ttrain.main(_argv(workdir, "bkg", "port_bkg"), device="cpu")
    human = ttrain.main(_argv(workdir, "human", "port_human", "--load_background", "port_bkg"),
                        device="cpu")
    return bkg, human


@pytest.fixture(scope="module")
def jax_bkg(workdir):
    """The JAX command line's stage 1 for 0 steps, its validation cut to
    the checkpoint (the steps and the validation render would only add
    their compiles): the checkpoint of the nets it draws from its seed.
    Returns its config (params.json written)."""
    import neuman_tpu.trainers.background as jbkg_mod

    opt = jconfig.from_cli(_argv(workdir, "bkg", "jax_bkg", "--max_iter", "0"))
    opt.save()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbkg_mod.NeRFTrainer, "validate", jbkg_mod.NeRFTrainer.save_model)
        jtrain.train_background(opt)
    return opt


class _Recorder:
    """Stands in for a trainer class: records its arguments, trains nothing."""

    calls = []

    def __init__(self, *args, **kwargs):
        _Recorder.calls.append((args, kwargs))

    def train(self):
        pass


def _recorded(monkeypatch, module, name, run):
    _Recorder.calls = []
    monkeypatch.setattr(module, name, _Recorder)
    run()
    (call,) = _Recorder.calls
    return call


@pytest.mark.parametrize("stage", ["bkg", "human"])
def test_port_cli_outputs(port_runs, stage):
    """checkpoint.npz, params.json, metrics.jsonl with validation records and
    finite losses, validation PNGs that decode."""
    trainer = port_runs[0 if stage == "bkg" else 1]
    out = trainer.opt.out
    assert os.path.isfile(os.path.join(out, "checkpoint.npz"))
    assert tconfig.NeuManConfig.load(os.path.join(out, "params.json")).train_mode == (
        "bkg" if stage == "bkg" else "smpl_and_offset")
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert any(k.startswith("val_loss/") for r in records for k in r)
    losses = [v for r in records for k, v in r.items() if "loss" in k]
    assert losses and all(math.isfinite(v) for v in losses)
    pngs = [n for n in os.listdir(out) if n.endswith(".png")]
    assert len(pngs) == (2 if stage == "bkg" else 8)
    assert all(png.read_png(os.path.join(out, n)).shape == (48, 64, 3) for n in pngs)
    assert trainer.iteration == 2


@pytest.mark.parametrize("stage", ["bkg", "human"])
def test_profile_dir_writes_a_trace_of_the_program_s_spans(port_runs, workdir, tmp_path, stage):
    """--profile_dir: --profile_steps steps from iteration 1 run under
    torch.profiler, and one chrome trace holds the program's spans."""
    extra = ["--profile_dir", str(tmp_path / "prof"), "--profile_steps", "1"]
    if stage == "human":
        extra += ["--load_background", "port_bkg"]
    ttrain.main(_argv(workdir, stage, f"port_prof_{stage}", *extra), device="cpu")
    assert os.listdir(tmp_path / "prof") == [f"{stage}_steps_1-1.json"]
    events = json.loads((tmp_path / "prof" / f"{stage}_steps_1-1.json").read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    want = {"step.backward", "step.optimizer", "step.readback"}
    assert want | ({"human.warp"} if stage == "human" else set()) <= spans


def test_port_human_stage_keeps_the_loaded_background(port_runs):
    """Stage 2 froze the background it loaded: its checkpoint's background
    nets are stage 1's."""
    bkg = jckpt.load_checkpoint(os.path.join(port_runs[0].opt.out, "checkpoint.npz"))
    human = jckpt.load_checkpoint(os.path.join(port_runs[1].opt.out, "checkpoint.npz"))
    for key, name in (("coarse_model", "coarse_bkg_net"), ("fine_model", "fine_bkg_net")):
        a, b = jckpt.flatten_tree(bkg[key]), jckpt.flatten_tree(human["hybrid_model"][name])
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mode", ["bkg", "smpl_only", "smpl_and_offset"])
def test_same_argv_same_config(workdir, mode):
    """Every field, after both packages parse one command line; the two the
    JAX config resolves from its backend agree once given."""
    argv = ["--train_mode", mode, "--scene_dir", workdir[0], "--image_height", "24",
            "--image_width", "32", "--lpips_weights", "w.npz", "--compute_dtype", "bfloat16"]
    if mode == "smpl_only":
        argv += ["--offset_scale", "0"]
    j, t = dataclasses.asdict(jconfig.from_cli(argv)), dataclasses.asdict(tconfig.from_cli(argv))
    assert j.keys() == t.keys()
    assert [k for k in j if j[k] != t[k]] == list(BACKEND_FIELDS)
    given = argv + [f"--{k}={v}" for k in BACKEND_FIELDS for v in ["false"]]
    assert dataclasses.asdict(jconfig.from_cli(given)) == dataclasses.asdict(tconfig.from_cli(given))
    assert t["tgt_size"] == (24, 32)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_params_json_loads_in_the_other_package(port_runs, jax_bkg, direction):
    if direction == "port_to_jax":
        path, load = os.path.join(port_runs[0].opt.out, "params.json"), jconfig.NeuManConfig.load
        want = dataclasses.asdict(tconfig.NeuManConfig.load(path))
    else:
        path, load = os.path.join(jax_bkg.out, "params.json"), tconfig.NeuManConfig.load
        want = dataclasses.asdict(jconfig.NeuManConfig.load(path))
    assert dataclasses.asdict(load(path)) == want
    assert want["name"] == ("port_bkg" if direction == "port_to_jax" else "jax_bkg")


def test_jax_background_loads_through_port_cli(workdir, jax_bkg, monkeypatch):
    """--load_background of the JAX command line's checkpoint: the port's
    background nets equal it."""
    argv = _argv(workdir, "human", "port_from_jax", "--load_background", "jax_bkg")
    args, kwargs = _recorded(monkeypatch, ttrain, "HumanNeRFTrainer",
                             lambda: ttrain.main(argv, device="cpu"))
    model = args[1]
    data = jckpt.load_checkpoint(os.path.join(jax_bkg.out, "checkpoint.npz"))
    for net, key in ((model.coarse_bkg_net, "coarse_model"), (model.fine_bkg_net, "fine_model")):
        got = jckpt.flatten_tree(convert.to_jax_params(net.state_dict()))
        want = jckpt.flatten_tree(data[key])
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], np.asarray(want[k], np.float32)) for k in got)


def test_port_background_loads_in_jax(port_runs):
    """The reverse: the port's stage-1 checkpoint through the JAX package's
    load_checkpoint and safe_merge_params into JAX nets equal to the port's."""
    trainer = port_runs[0]
    data = jckpt.load_checkpoint(os.path.join(trainer.opt.out, "checkpoint.npz"))
    opt = jconfig.from_cli(BKG + TINY)
    spec = jnerf.build_nerf_specs(opt)
    import jax

    for k, key in (("coarse", "coarse_model"), ("fine", "fine_model")):
        init = jnerf.init_nerf_params(jax.random.PRNGKey(0), spec.nerf)
        merged, missing = jckpt.safe_merge_params(init, data[key])
        assert not missing
        got = jckpt.flatten_tree(merged)
        want = jckpt.flatten_tree(convert.to_jax_params(trainer.state["params"][k].state_dict()))
        assert got.keys() == want.keys()
        assert all(np.array_equal(np.asarray(got[n]), want[n]) for n in got)


def _human_setups(workdir, monkeypatch, *extra):
    """What each command line's stage 2 hands its trainer, at the default
    LPIPS weight (no weights file: LPIPS off) and geo_threshold (from the
    scene's bones)."""
    import neuman_tpu.trainers.human as jhuman_mod

    argv = [a for a in _argv(workdir, "human", "setup", *extra)]
    for flag in ("--penalize_lpips", "--geo_threshold"):
        i = argv.index(flag)
        del argv[i:i + 2]
    j = _recorded(monkeypatch, jhuman_mod, "HumanNeRFTrainer",
                  lambda: jtrain.train_human(jconfig.from_cli(argv)))
    t = _recorded(monkeypatch, ttrain, "HumanNeRFTrainer",
                  lambda: ttrain.main(argv, device="cpu"))
    return j, t


def test_human_stage_setup_matches_jax(workdir, monkeypatch, capsys):
    """auto_geo_threshold, interval_comp, the views, the alignments and the
    SMPL state, and LPIPS off with the JAX command line's warning."""
    (jargs, jkw), (targs, tkw) = _human_setups(workdir, monkeypatch)
    jopt, _, jparams, jscene, jtrain_v, jval_v, _ = jargs
    topt, model, tscene, ttrain_v, tval_v, _ = targs
    np.testing.assert_allclose(topt.geo_threshold, jopt.geo_threshold, rtol=1e-5)
    assert topt.geo_threshold > 0
    np.testing.assert_allclose(tkw["interval_comp"], jkw["interval_comp"], rtol=1e-5)
    assert (ttrain_v, tval_v) == (jtrain_v, jval_v)
    np.testing.assert_array_equal(tscene.alignments.astype(np.float32),
                                  np.asarray(jparams["alignments"]))
    np.testing.assert_array_equal(model.alignments.detach().numpy(),
                                  np.asarray(jparams["alignments"]))
    for name in ("poses", "betas"):
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(),
                                      np.asarray(jparams[name]))
    assert jkw["lpips_params"] is None and tkw["lpips_params"] is None
    assert topt.penalize_lpips == jopt.penalize_lpips > 0
    warning = "warning: no LPIPS weights at data/lpips_alex.npz; lpips loss off"
    assert capsys.readouterr().out.count(warning) == 2
    for jc, tc in zip(jscene.captures, tscene.captures):
        np.testing.assert_array_equal(tc.border_mask, jc.border_mask)


def test_background_stage_setup_matches_jax(workdir, monkeypatch):
    """The views, the ray classes and the depth maps each command line's
    stage 1 hands its trainer."""
    import neuman_tpu.trainers.background as jbkg_mod

    argv = _argv(workdir, "bkg", "setup_bkg")
    jargs, _ = _recorded(monkeypatch, jbkg_mod, "NeRFTrainer",
                         lambda: jtrain.train_background(jconfig.from_cli(argv)))
    targs, tkw = _recorded(monkeypatch, ttrain, "NeRFTrainer",
                           lambda: ttrain.main(argv, device="cpu"))
    assert targs[4:6] == jargs[4:6]
    for jc, tc in zip(jargs[3].captures, targs[3].captures):
        np.testing.assert_array_equal(tc.border_mask, jc.border_mask)
        np.testing.assert_array_equal(tc.depth_map, jc.depth_map)
        assert (tc.near["bkg"], tc.far["bkg"]) == (jc.near["bkg"], jc.far["bkg"])
    assert tkw["mlp"] is not nerf_mlp_plain


def test_use_pallas_false_selects_the_plain_ops(workdir, monkeypatch):
    _, kw = _recorded(monkeypatch, ttrain, "NeRFTrainer", lambda: ttrain.main(
        _argv(workdir, "bkg", "plain_bkg", "--use_pallas", "false"), device="cpu"))
    assert kw["mlp"] is nerf_mlp_plain
    _, kw = _recorded(monkeypatch, ttrain, "HumanNeRFTrainer", lambda: ttrain.main(
        _argv(workdir, "human", "plain_human", "--use_pallas", "false"), device="cpu"))
    assert kw["ops"] is thuman.PLAIN
    _, kw = _recorded(monkeypatch, ttrain, "HumanNeRFTrainer", lambda: ttrain.main(
        _argv(workdir, "human", "kernel_human"), device="cpu"))
    assert kw["ops"] is thuman.KERNELS


def test_load_can_and_a_failed_load(port_runs, workdir, monkeypatch, capsys):
    """--load_can puts the canonical net of a human checkpoint in place; a
    --load_background that does not exist trains from scratch, as the JAX
    command line does."""
    argv = _argv(workdir, "human", "can", "--load_can", "port_human",
                 "--load_background", "no_such_run")
    (_, model, *_), _ = _recorded(monkeypatch, ttrain, "HumanNeRFTrainer",
                                  lambda: ttrain.main(argv, device="cpu"))
    assert "train from scratch" in capsys.readouterr().out
    data = jckpt.load_checkpoint(os.path.join(port_runs[1].opt.out, "checkpoint.npz"))
    got = jckpt.flatten_tree(convert.to_jax_params(model.coarse_human_net.state_dict()))
    want = jckpt.flatten_tree(data["hybrid_model"]["coarse_human_net"])
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_main_needs_the_card_unless_asked_for_the_cpu(workdir):
    """No CUDA device here: the default device raises before any work."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(_argv(workdir, "bkg", "no_card"))
    assert not os.path.exists(os.path.join(workdir[1], "no_card"))


def test_module_entry_point(workdir):
    """`python -m neuman_tpu_torch.train` parses its flags and, with no
    card, stops with the reason."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "neuman_tpu_torch.train",
                           *_argv(workdir, "bkg", "entry")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
