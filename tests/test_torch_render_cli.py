"""The port's test-view and 360 command lines (`python -m
neuman_tpu_torch.render_test_views`, `... .render_360`) and its metrics
against the JAX package's render_test_views.py, render_360.py and
neuman_tpu/utils/metrics.py.

Both packages render from one checkpoint, on one module-scoped
`tests/fixtures.build_synthetic_scene` (48x64, 10 frames) read at 24x32:
random JAX `init_human_nerf_params` at the TINY widths of tests/test_cli.py
(density biases raised so that the background and the body show), saved
with the JAX `save_checkpoint` as {"hybrid_model": ...}; nothing is trained.
Each command line runs in-process on the CPU, the JAX one from its own
working directory and the port's from another (both write ./demo/...). The
renders are bf16, their default in both packages; a frame of the port is
held to the JAX one at >= 40 dB, the repo's image-parity bar.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import render_360 as j360
import render_test_views as jrtv
from neuman_tpu.data_io import neuman as jneuman
from neuman_tpu.models import human_nerf as jhn
from neuman_tpu.models import lpips as jlpips
from neuman_tpu.options import config as jconfig
from neuman_tpu.render import paths as jpaths
from neuman_tpu.render import renderer as jrenderer
from neuman_tpu.trainers import checkpoint as jckpt
from neuman_tpu.utils import metrics as jmetrics
from neuman_tpu.utils.misc import smpl_verts_to_center_and_up as j_center_and_up
from neuman_tpu_torch import render_360 as t360
from neuman_tpu_torch import render_test_views as trtv
from neuman_tpu_torch.data_io import neuman as tneuman
from neuman_tpu_torch.models import lpips as tlpips
from neuman_tpu_torch.render import paths as tpaths
from neuman_tpu_torch.render import renderer as trenderer
from neuman_tpu_torch.utils import metrics as tmetrics
from neuman_tpu_torch.utils import png
from neuman_tpu_torch.utils.misc import smpl_verts_to_center_and_up as t_center_and_up
from tests.fixtures import build_synthetic_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--nerf_depth", "2", "--nerf_width", "32", "--pos_N_freqs", "4", "--pos_max_freq", "3",
        "--dir_N_freqs", "2", "--dir_max_freq", "1", "--samples_per_ray", "8",
        "--importance_samples_per_ray", "8"]
RENDER_HW = ("--render_h", "24", "--render_w", "32")
MIN_PSNR = 40.0
# the 360 cameras: the path itself is float64 numpy in both packages (equal
# to 1e-12 from one centre and up); the centre and up come from f32 joint
# sums, which XLA and torch add in other orders (~5e-8), so the command
# lines' cameras agree to f32 rounding carried through the SVD and the path
CAMERA_ATOL = 1e-5


def make_checkpoint(path, seed):
    """A random JAX HumanNeRF at the TINY widths saved as a human-stage
    checkpoint; density biases +0.5 (background) and +2 (body), so that a
    frame shows both branches. Returns the path."""
    opt = jconfig.from_cli(TINY, mode_aware=False)
    params = jax.tree_util.tree_map(
        np.asarray, jhn.init_human_nerf_params(jax.random.PRNGKey(seed),
                                               jhn.build_human_nerf_spec(opt)))
    for name, bias in (("coarse_bkg_net", 0.5), ("fine_bkg_net", 0.5), ("coarse_human_net", 2.0)):
        params[name]["alpha_linear"]["b"] = params[name]["alpha_linear"]["b"] + bias
    jckpt.save_checkpoint(str(path), {"hybrid_model": params})
    return str(path)


def make_setup(tmp_path_factory, name):
    """(scene dir, checkpoint path, root) under a fresh directory;
    NEUMAN_DATA_ROOT set to the scene's body model."""
    root = tmp_path_factory.mktemp(name)
    scene_dir = build_synthetic_scene(root)
    return scene_dir, make_checkpoint(root / "human_ckpt.npz", seed=1), root


def jax_options(argv, **base):
    """The JAX scripts' config: their `__main__` base and flags."""
    cfg = jconfig.NeuManConfig(offset_scale=1.0, geo_threshold=-1.0, **base)
    return jconfig.from_cli(argv, mode_aware=False, base=cfg)


def read_frames(cwd, what):
    """{name: uint8 frame} of cwd/demo/<what>."""
    d = os.path.join(cwd, "demo", what)
    return {n: png.read_png(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def frame_psnr(a, b):
    mse = np.mean((a.astype(np.float64) / 255.0 - b.astype(np.float64) / 255.0) ** 2)
    return np.inf if mse == 0 else -10.0 * np.log10(mse)


def assert_frames_alike(jax_dir, port_dir, what):
    want, got = read_frames(jax_dir, what), read_frames(port_dir, what)
    assert list(got) == list(want) and want
    for name in want:
        assert got[name].shape == want[name].shape
        assert frame_psnr(got[name], want[name]) >= MIN_PSNR, name


class Recorder:
    """Wraps a renderer function: records each call's camera-to-world and
    calls through."""

    def __init__(self, fn):
        self.fn, self.c2w = fn, []

    def __call__(self, spec, model, cap, *args, **kw):
        self.c2w.append(np.asarray(cap.cam_pose.camera_to_world))
        return self.fn(spec, model, cap, *args, **kw)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    before = os.environ.get("NEUMAN_DATA_ROOT")
    yield make_setup(tmp_path_factory, "torch_render_cli")
    if before is None:
        os.environ.pop("NEUMAN_DATA_ROOT", None)
    else:
        os.environ["NEUMAN_DATA_ROOT"] = before


def _run_pair(setup, tag, jax_fn, port_fn, argv, record=None):
    """Run the JAX and the port command line from two working directories
    under the setup's root. Returns (jax dir, port dir, jax result, port
    result, {side: recorded camera-to-world} when `record` names the
    renderer function to record)."""
    scene_dir, ckpt, root = setup
    argv = ["--scene_dir", scene_dir, "--weights_path", ckpt, *RENDER_HW, *TINY, *argv]
    out, cams = [], {}
    for side, fn, mod in (("jax", jax_fn, jrenderer), ("port", port_fn, trenderer)):
        cwd = root / f"{tag}_{side}"
        cwd.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(cwd)
            if record:
                rec = Recorder(getattr(mod, record))
                mp.setattr(mod, record, rec)
            out.append((str(cwd), fn(argv)))
            if record:
                cams[side] = np.stack(rec.c2w)
    (jdir, jres), (tdir, tres) = out
    return jdir, tdir, jres, tres, cams


@pytest.fixture(scope="module")
def test_views(setup):
    return _run_pair(setup, "test_views", lambda a: jrtv.main(jax_options(a)),
                     lambda a: trtv.main(a, device="cpu"), [])


@pytest.fixture(scope="module", params=["canonical_360", "posed_360"])
def orbit(setup, request):
    mode = request.param
    jmain = j360.main_canonical_360 if mode == "canonical_360" else j360.main_posed_360
    return mode, _run_pair(setup, mode, lambda a: jmain(jax_options(a)),
                           lambda a: t360.main(["--mode", mode, *a], device="cpu"),
                           ["--trajectory_resolution", "2"], record="render_smpl_nerf")


def test_test_views_frames_match_jax(test_views, setup):
    jdir, tdir, _, _, _ = test_views
    assert_frames_alike(jdir, tdir, "test_views/scene")


def test_test_views_score_the_written_png(test_views, setup):
    """The port's scores are the JAX metrics of its PNG read back against
    the capture's image at the render size; no LPIPS without weights."""
    scene_dir = setup[0]
    _, tdir, jres, tres, _ = test_views
    assert set(tres) == set(jres) == {"ssim", "psnr", "lpips"}
    assert tres["lpips"] is None and jres["lpips"] is None
    scene = jneuman.NeuManReader.read_scene(scene_dir, tgt_size=(24, 32), normalize=True,
                                            bkg_range_scale=3.0, human_range_scale=1.5,
                                            smpl_type="optimized")
    test_views = jneuman.read_text(os.path.join(scene_dir, "test_split.txt"))
    preds = list(read_frames(tdir, "test_views/scene").values())
    want = jmetrics.eval_metrics([scene[v].image for v in test_views], preds)
    for k in ("ssim", "psnr"):
        assert abs(tres[k] - want[k]) <= 1e-12


def test_orbit_frames_match_jax(orbit):
    mode, (jdir, tdir, _, tres, _) = orbit
    assert_frames_alike(jdir, tdir, f"{mode}/scene")
    assert [os.path.basename(p) for p in tres] == ["out_0000.png", "out_0001.png"]


def test_orbit_cameras_match_jax(orbit, setup):
    """The cameras each command line rendered from, and the path itself
    from one centre and up to 1e-12."""
    mode, (_, _, _, _, cams) = orbit
    assert cams["port"].shape == cams["jax"].shape == (2, 4, 4)
    np.testing.assert_allclose(cams["port"], cams["jax"], rtol=0, atol=CAMERA_ATOL)
    scene_dir = setup[0]
    kw = dict(tgt_size=(24, 32), normalize=True, bkg_range_scale=3.0, human_range_scale=1.5,
              smpl_type="optimized")
    jscene = jneuman.NeuManReader.read_scene(scene_dir, **kw)
    tscene = tneuman.NeuManReader.read_scene(scene_dir, **kw)
    verts = (lambda s: s.static_vert[0]) if mode == "canonical_360" else (lambda s: s.verts[0])
    jc, ju = j_center_and_up(verts(jscene), jneuman.NeuManReader._body_model())
    tc, tu = t_center_and_up(verts(tscene), tneuman.NeuManReader._body_model())
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-6)
    for dist in (3.0, 0.7):
        want = np.stack([p.camera_to_world for p in jpaths.default_360_path(jc, ju, dist, 5)])
        got = np.stack([p.camera_to_world for p in tpaths.default_360_path(jc, ju, dist, 5)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_pose_spherical_matches_jax():
    for theta, phi, radius in ((0.0, 0.0, 3.0), (-72.0, 15.0, 1.3), (144.0, -30.0, 0.2)):
        want = jpaths.pose_spherical(theta, phi, radius)
        got = tpaths.pose_spherical(theta, phi, radius)
        np.testing.assert_allclose(got.camera_to_world, want.camera_to_world, rtol=0, atol=1e-12)


def _uint8_pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=shape, dtype=np.uint8)
    noise = rng.integers(-12, 13, size=shape)
    return a, np.clip(a.astype(np.int64) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(24, 32, 3), (48, 64, 3), (37, 53, 3), (20, 30)])
def test_psnr_ssim_eval_metrics_match_jax(shape):
    """Bit for bit where both run the same float64 numpy and scipy: PSNR,
    SSIM in both argument orders (data range from the first image's
    dtype), the mean over pairs, and a float image's unit data range."""
    pairs = [_uint8_pair(shape, s) for s in range(3)]
    for gt, pred in pairs:
        assert abs(tmetrics.psnr(gt, pred) - jmetrics.psnr(gt, pred)) <= 1e-12
        assert abs(tmetrics.ssim(pred, gt) - jmetrics.ssim(pred, gt)) <= 1e-12
        assert abs(tmetrics.ssim(gt, pred) - jmetrics.ssim(gt, pred)) <= 1e-12
        f = gt.astype(np.float64) / 255.0
        assert abs(tmetrics.ssim(f, pred / 255.0) - jmetrics.ssim(f, pred / 255.0)) <= 1e-12
    if len(shape) == 3:
        got = tmetrics.eval_metrics(*zip(*pairs))
        want = jmetrics.eval_metrics(*zip(*pairs))
        assert got["lpips"] is None and want["lpips"] is None
        assert all(abs(got[k] - want[k]) <= 1e-12 for k in ("ssim", "psnr"))
    assert tmetrics.psnr(pairs[0][0], pairs[0][0]) == np.inf


def test_lpips_distance_matches_jax():
    """LPIPS on seeded JAX weights, carried over and back in the JAX layout;
    within 1e-5 per pair, and the mean in eval_metrics."""
    params = jax.tree_util.tree_map(np.asarray, jlpips.init_lpips_params(jax.random.PRNGKey(4)))
    tparams = tlpips.lpips_params_from_jax(params)
    back = tlpips.lpips_params_to_jax(tparams)
    flat_a, flat_b = jckpt.flatten_tree(back), jckpt.flatten_tree(params)
    assert set(flat_a) == set(flat_b)
    assert all(np.array_equal(flat_a[k], flat_b[k]) for k in flat_b)
    pairs = [_uint8_pair((64, 64, 3), s) for s in range(2)]
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    for gt, pred in pairs:
        want = jmetrics.lpips_distance(jparams, gt, pred)
        assert abs(tmetrics.lpips_distance(tparams, gt, pred) - want) <= 1e-5
    got = tmetrics.eval_metrics(*zip(*pairs), lpips_params=tparams)
    want = jmetrics.eval_metrics(*zip(*pairs), lpips_params=jparams)
    assert abs(got["lpips"] - want["lpips"]) <= 1e-5
    assert tmetrics.lpips_distance(None, *pairs[0]) is None


@pytest.mark.parametrize("hw", [(24, 32), (48, 64), (270, 480)])
def test_frames_survive_the_png_round_trip(hw):
    """The frame the test views score is the frame they wrote."""
    frame = np.random.default_rng(hw[0]).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    assert np.array_equal(png.decode_png(png.encode_png(frame)), frame)


@pytest.mark.parametrize("module,extra", [(trtv, []), (t360, ["--mode", "canonical_360"]),
                                          (t360, ["--mode", "posed_360"])])
def test_main_needs_the_card_unless_asked_for_the_cpu(module, extra, setup, tmp_path,
                                                      monkeypatch):
    """With no CUDA device the default device raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    scene_dir, ckpt, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([*extra, "--scene_dir", scene_dir, "--weights_path", ckpt, *TINY])
    assert not os.path.exists(tmp_path / "demo")


def test_auto_geo_threshold_only(setup, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    scene_dir, ckpt, _ = setup
    argv = ["--scene_dir", scene_dir, "--weights_path", ckpt, "--geo_threshold", "0.2"]
    for main in (lambda: trtv.main(argv, device="cpu"),
                 lambda: t360.main(["--mode", "posed_360", *argv], device="cpu")):
        with pytest.raises(ValueError, match="automatic geo_threshold"):
            main()


def test_module_help_and_mode():
    """`python -m neuman_tpu_torch.render_360 --help` prints the flags;
    without --mode it stops with the reason."""
    env = {**os.environ, "PYTHONPATH": REPO}
    run = lambda *a: subprocess.run([sys.executable, "-m", "neuman_tpu_torch.render_360", *a],
                                    cwd=REPO, env=env, capture_output=True, text=True,
                                    timeout=120)
    proc = run("--help")
    assert proc.returncode == 0 and "--trajectory_resolution" in proc.stdout
    proc = run("--scene_dir", "x")
    assert proc.returncode != 0 and "--mode" in proc.stderr
