"""The port's reposing and gathering command lines (`python -m
neuman_tpu_torch.render_reposing`, `... .render_gathering`) and their pose
chain against the JAX package's render_reposing.py and render_gathering.py.

One module-scoped `tests/fixtures.build_synthetic_scene` (48x64, 10 frames,
read at 24x32) and checkpoints of random JAX HumanNeRFs at the TINY widths
(see tests/test_torch_render_cli.py); a 3-frame motion in the AMASS layout
(`tools/synthetic_scene.write_mocap_npz`). Each command line runs
in-process on the CPU from its own working directory, where the gathering
finds its actors' checkpoints (./out/<actor>_human), their SMPL fits
(<dirname(scene_dir)>/<actor>) and the motion (./data/SFU/...), as the
JAX script hard-codes them.
"""

import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import render_gathering as jgather
import render_reposing as jrepose
from neuman_tpu.data_io import neuman as jneuman
from neuman_tpu.geometry import transforms as jtf
from neuman_tpu.models import smpl as jsmpl
from neuman_tpu_torch import render_gathering as tgather
from neuman_tpu_torch import render_reposing as trepose
from neuman_tpu_torch.data_io import neuman as tneuman
from neuman_tpu_torch.geometry import transforms as ttf
from neuman_tpu_torch.models import smpl as tsmpl
from neuman_tpu_torch.render import cli as tcli
from neuman_tpu_torch.tools.synthetic_scene import write_mocap_npz
from tests.test_torch_render_cli import (RENDER_HW, TINY, assert_frames_alike, jax_options,
                                         make_checkpoint, make_setup)

torch.set_num_threads(1)

READ = dict(tgt_size=(24, 32), normalize=True, bkg_range_scale=3.0, human_range_scale=1.5,
            smpl_type="optimized")
# f32 skinning in XLA's and torch's orders, then the same float64 products
POSE_RTOL, POSE_ATOL = 1e-5, 1e-6
MOCAP_FRAMES = 3
# the gathering preset takes frames 0:800:4
GATHER_MOCAP_FRAMES = 9
BIKE = ("bike", "jumpandroll")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    before = os.environ.get("NEUMAN_DATA_ROOT")
    scene_dir, ckpt, root = make_setup(tmp_path_factory, "torch_reposing")
    mocap = write_mocap_npz(str(root / "motion_poses.npz"), MOCAP_FRAMES, seed=0)
    yield scene_dir, ckpt, root, mocap
    if before is None:
        os.environ.pop("NEUMAN_DATA_ROOT", None)
    else:
        os.environ["NEUMAN_DATA_ROOT"] = before


@pytest.fixture(scope="module")
def scenes(setup):
    return (jneuman.NeuManReader.read_scene(setup[0], **READ),
            tneuman.NeuManReader.read_scene(setup[0], **READ))


def _opts(setup, scene_dir=None, motion_name="test_motion"):
    argv = ["--scene_dir", scene_dir or setup[0], "--mocap_path", setup[3], "--mocap_start", "0",
            "--mocap_end", "-1", "--mocap_skip", "1", "--motion_name", motion_name, *TINY]
    return jax_options(argv), tcli.options(argv)


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (95.8, 10.4, 1.8), (90.4, -10.9, 4.0),
                                    (-170.0, 45.0, 300.0)])
def test_transforms_match_jax(angles):
    """The numpy helpers are the same float64 operations: equal."""
    a = np.array(angles) / 180 * np.pi
    np.testing.assert_array_equal(ttf.euler_matrix(*a), jtf.euler_matrix(*a))
    axis, point = np.array([0.3, -1.0, 2.0]) + a[0], np.array([0.1, 0.2, -0.3])
    np.testing.assert_array_equal(ttf.rotation_matrix(a[1], axis), jtf.rotation_matrix(a[1], axis))
    np.testing.assert_array_equal(ttf.rotation_matrix(a[2], axis, point),
                                  jtf.rotation_matrix(a[2], axis, point))
    np.testing.assert_array_equal(ttf.unit_vector(axis), jtf.unit_vector(axis))
    for directed in (True, False):
        assert (ttf.angle_between_vectors(axis, point, directed)
                == jtf.angle_between_vectors(axis, point, directed))
    with pytest.raises(NotImplementedError):
        ttf.euler_matrix(*a, axes="rzyx")


def test_verts_transformations_with_transl_match_jax():
    """verts_transformations(transl=), smpl_forward(transl=) and
    vertices2joints against the JAX model; without transl the results are
    what they were (lbs)."""
    jm = jsmpl.synthetic_smpl_model(num_verts=64, num_joints=6)
    tm = tsmpl.SMPLModel.from_numpy(jm.v_template, jm.shapedirs, jm.J_regressor,
                                    jm.lbs_weights, jm.parents, jm.faces)
    rng = np.random.default_rng(5)
    pose = (rng.normal(size=(1, 18)) * 0.3).astype(np.float32)
    betas = (rng.normal(size=(1, 10)) * 0.5).astype(np.float32)
    transl = (rng.normal(size=(1, 3)) * 0.4).astype(np.float32)
    t = torch.from_numpy
    jv, jt = jsmpl.verts_transformations(jm, jnp.asarray(pose), jnp.asarray(betas),
                                         transl=jnp.asarray(transl))
    tv, tt = tsmpl.verts_transformations(tm, t(pose), t(betas), transl=t(transl))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    assert torch.equal(tsmpl.verts_transformations(tm, t(pose), t(betas))[1],
                       tsmpl.lbs(t(betas), t(pose), tm)[0])
    for tr in (None, transl):
        jverts, jjoints = jsmpl.smpl_forward(jm, jnp.asarray(pose), jnp.asarray(betas),
                                             transl=None if tr is None else jnp.asarray(tr))
        tverts, tjoints = tsmpl.smpl_forward(tm, t(pose), t(betas),
                                             transl=None if tr is None else t(tr))
        np.testing.assert_allclose(tverts.numpy(), np.asarray(jverts), atol=1e-5)
        np.testing.assert_allclose(tjoints.numpy(), np.asarray(jjoints), atol=1e-5)
    verts = rng.normal(size=(2, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(tsmpl.vertices2joints(tm.J_regressor, t(verts)).numpy(),
                               np.asarray(jsmpl.vertices2joints(jm.J_regressor, verts)),
                               atol=1e-6)


@pytest.mark.parametrize("preset", ["identity", "bike_jumpandroll"])
def test_read_human_poses_match_jax(setup, scenes, preset, monkeypatch):
    """The posed vertices and T_da2scene of each mocap frame, with the
    identity alignment and with the bike / jumpandroll preset (euler angles,
    scale 0.14, a translation)."""
    jopt, topt = _opts(setup)
    if preset != "identity":
        bike = types.SimpleNamespace(scene_dir=os.path.join("x", BIKE[0]), motion_name=BIKE[1])
        fixed = jrepose.get_manual_alignment(bike)
        for (a, b) in zip(trepose.get_manual_alignment(bike), fixed):
            np.testing.assert_array_equal(a, b)
        monkeypatch.setattr(jrepose, "get_manual_alignment", lambda opt: fixed)
        monkeypatch.setattr(trepose, "get_manual_alignment", lambda opt: fixed)
    jverts, jts = jrepose.read_human_poses(jopt, scenes[0])
    tverts, tts = trepose.read_human_poses(topt, scenes[1])
    assert len(tverts) == len(jverts) == MOCAP_FRAMES
    for a, b in zip(tverts, jverts):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=POSE_RTOL, atol=POSE_ATOL)
    for a, b in zip(tts, jts):
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=POSE_RTOL, atol=POSE_ATOL)
    assert not np.allclose(tverts[0], tverts[1])


def test_mocap_presets_and_skip_match_jax(setup):
    """The preset paths and alignments; --mocap_end -1 reads to the end,
    skip and start as given."""
    for name in (BIKE, ("seattle", "jumpandroll")):
        opt = types.SimpleNamespace(scene_dir=os.path.join("x", name[0]), motion_name=name[1])
        for a, b in zip(trepose.get_manual_alignment(opt), jrepose.get_manual_alignment(opt)):
            np.testing.assert_array_equal(a, b)
    opt = types.SimpleNamespace(scene_dir="x/bike", motion_name="jumpandroll")
    assert trepose.get_mocap_path(opt) == jrepose.get_mocap_path(opt)
    with pytest.raises(ValueError):
        trepose.get_mocap_path(types.SimpleNamespace(scene_dir="x/y", motion_name="z"))
    for actor in ("seattle", "citron", "parkinglot", "other"):
        for a, b in zip(tgather.get_manual_alignment("dance_together", actor),
                        jgather.get_manual_alignment("dance_together", actor)):
            np.testing.assert_array_equal(a, b)
    assert tgather.get_mocap_path("dance_together") == jgather.get_mocap_path("dance_together")
    poses, trans = trepose.read_mocap(setup[3], 1, None, 2)
    raw = np.load(setup[3])
    np.testing.assert_array_equal(poses[:, :66], raw["poses"][1::2, :66])
    assert poses.shape == (1, 72) and not poses[:, 66:].any()
    np.testing.assert_array_equal(trans, raw["trans"][1::2])


@pytest.mark.parametrize("script", ["reposing", "gathering"])
def test_read_novel_caps_match_jax(scenes, setup, script):
    """The dollied cameras equal the JAX ones; the scene's captures keep
    their poses."""
    jmod, tmod = (jrepose, trepose) if script == "reposing" else (jgather, tgather)
    jopt, topt = _opts(setup)
    before = [c.cam_pose.camera_to_world.copy() for c in scenes[1].captures]
    jcaps = jmod.read_novel_caps(jopt, 4, scenes[0])
    tcaps = tmod.read_novel_caps(topt, 4, scenes[1])
    assert len(tcaps) == 4
    for a, b in zip(tcaps, jcaps):
        np.testing.assert_allclose(a.cam_pose.camera_to_world, b.cam_pose.camera_to_world,
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(a.intrinsic_matrix, b.intrinsic_matrix)
    assert np.linalg.norm(tcaps[1].cam_pose.camera_center_in_world
                          - tcaps[0].cam_pose.camera_center_in_world) > 0.01
    for c, m in zip(scenes[1].captures, before):
        np.testing.assert_array_equal(c.cam_pose.camera_to_world, m)


def _in_dir(path, fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        return fn()


def test_reposed_frames_match_jax(setup):
    scene_dir, ckpt, root, mocap = setup
    argv = ["--scene_dir", scene_dir, "--weights_path", ckpt, "--mocap_path", mocap,
            *RENDER_HW, *TINY]
    jdir, tdir = root / "repose_jax", root / "repose_port"
    jdir.mkdir()
    tdir.mkdir()
    _in_dir(jdir, lambda: jrepose.main(jax_options(argv)))
    saved = _in_dir(tdir, lambda: trepose.main(argv, device="cpu"))
    assert len(saved) == MOCAP_FRAMES
    assert_frames_alike(str(jdir), str(tdir), "reposing/scene")


def test_gathering_frames_match_jax(setup):
    """Two actors with their own nets and fits, laid out where the JAX
    script looks for them; the background from --weights_path."""
    scene_dir, ckpt, root, _ = setup
    actors = {"seattle": ckpt, "citron": make_checkpoint(root / "citron_ckpt.npz", seed=2)}
    for actor in actors:
        fits = os.path.join(os.path.dirname(scene_dir), actor)
        os.makedirs(fits, exist_ok=True)
        shutil.copy(os.path.join(scene_dir, "smpl_output_optimized.pkl"), fits)
    dirs = {}
    for side in ("jax", "port"):
        cwd = root / f"gather_{side}"
        for actor, path in actors.items():
            os.makedirs(cwd / "out" / f"{actor}_human")
            shutil.copy(path, cwd / "out" / f"{actor}_human" / "checkpoint.npz")
        write_mocap_npz(str(cwd / "data/SFU/0018/0018_XinJiang002_poses.npz"),
                        GATHER_MOCAP_FRAMES, seed=3)
        dirs[side] = str(cwd)
    argv = ["--scene_dir", scene_dir, "--weights_path", ckpt, *RENDER_HW, *TINY]

    def jax_main():
        opt = jax_options(argv, motion_name="dance_together")
        opt.actors = list(actors)
        jgather.main(opt)

    _in_dir(dirs["jax"], jax_main)
    saved = _in_dir(dirs["port"], lambda: tgather.main(["--actors", *actors, *argv],
                                                       device="cpu"))
    assert len(saved) == 3
    assert_frames_alike(dirs["jax"], dirs["port"], "gathering/dance_together")


def test_main_needs_the_card_unless_asked_for_the_cpu(setup, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    scene_dir, ckpt, _, mocap = setup
    argv = ["--scene_dir", scene_dir, "--weights_path", ckpt, "--mocap_path", mocap, *TINY]
    for main in (trepose.main, tgather.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not os.path.exists(tmp_path / "demo")
