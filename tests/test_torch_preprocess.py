"""Preprocessing stages 9 and 10 of the port (`neuman_tpu_torch.preprocess`)
against the JAX package's `neuman_tpu.preprocess`, on the CPU.

The same numpy inputs from a seed go through both packages:
- the soft face rasteriser: random triangles with padded rows and two
  faces behind the camera, two chunk sizes, forward and gradient;
- the alignment's functions (`ransac_plane`, `solve_scale`,
  `solve_translation`) and the refinement's (`coco_to_smpl`,
  `turn_smpl_gradient_on`, `clip_smpl_vals`, `vertex_forward`, one step's
  loss and gated gradient, 20 steps) on tests/test_preprocess.py's
  articulated tube body, built in both packages from its arrays;
- the slice: `run_alignment` then `run_optimize_smpl` on a 4-frame 48x64
  scene of `tools/synthetic_scene.write_preprocess_inputs`, each package
  in its own copy; each reads the other's pickles;
- `gen_run`'s run.sh.
Each tolerance is stated beside its test.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from neuman_tpu.cameras.capture import ResizedPinholeCapture as JCapture
from neuman_tpu.cameras.pinhole import PinholeCamera as JPinhole
from neuman_tpu.cameras.pose import CameraPose as JPose
from neuman_tpu.geometry.rotation import Rotation as JRotation
from neuman_tpu.geometry.rotation import Translation as JTranslation
from neuman_tpu.models import smpl as jsmpl
from neuman_tpu.preprocess import alignment as jalign
from neuman_tpu.preprocess import cli as jcli
from neuman_tpu.preprocess import optimize_smpl as josm
from neuman_tpu.preprocess.soft_raster import soft_rasterize_silhouette as j_raster
from neuman_tpu.render.rasterize import rasterize_mesh
from neuman_tpu_torch.cameras.capture import ResizedPinholeCapture as TCapture
from neuman_tpu_torch.cameras.pinhole import PinholeCamera as TPinhole
from neuman_tpu_torch.cameras.pose import CameraPose as TPose
from neuman_tpu_torch.data_io import smpl_pickle
from neuman_tpu_torch.geometry.rotation import Rotation as TRotation
from neuman_tpu_torch.geometry.rotation import Translation as TTranslation
from neuman_tpu_torch.models import smpl as tsmpl
from neuman_tpu_torch.preprocess import alignment as talign
from neuman_tpu_torch.preprocess import cli as tcli
from neuman_tpu_torch.preprocess import gen_run as tgen
from neuman_tpu_torch.preprocess import optimize_smpl as tosm
from neuman_tpu_torch.preprocess.soft_raster import soft_rasterize_silhouette as t_raster
from neuman_tpu_torch.tools.synthetic_scene import write_preprocess_inputs
from tests.test_preprocess import _articulated_tube_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64
# rasteriser: alpha to 1e-5 (f32 sums of the same terms in another order);
# the gradient's L2 error over its L2 norm to 1e-4
RASTER_ATOL, RASTER_GRAD_REL = 1e-5, 1e-4
# refinement: one step's loss (relative) and gated gradient (L2 error over
# L2 norm); the pose after 20 Adam steps (radians): Adam's normalised
# steps of lr = 5e-3 carry a gradient's last-bit differences into the
# pose only where a component's gradient is near 0
STEP_LOSS_REL, STEP_GRAD_REL, POSE20_ATOL = 1e-5, 1e-4, 1e-4
# solve_translation after 1000 f32 Adam steps
TRANSLATION_ATOL = 1e-4


def _tube_bodies():
    jbody = _articulated_tube_model()
    tbody = tsmpl.SMPLModel.from_numpy(
        np.asarray(jbody.v_template), np.asarray(jbody.shapedirs),
        np.asarray(jbody.J_regressor), np.asarray(jbody.lbs_weights), jbody.parents,
        jbody.faces)
    return jbody, tbody


def _caps(t_cam=(0.0, -1.0, 3.0), focal=55.0):
    """One 48x64 camera in each package, identity rotation."""
    out = []
    for pinhole, pose, trans, rot, cap in ((JPinhole, JPose, JTranslation, JRotation, JCapture),
                                           (TPinhole, TPose, TTranslation, TRotation, TCapture)):
        cam = pinhole(W, H, focal, focal, W / 2, H / 2)
        p = pose(trans(np.array(t_cam, dtype=np.float32)), rot(np.array([1.0, 0, 0, 0])))
        out.append(cap(cam, p, (H, W)))
    return out


def _frame_inputs(seed=3):
    """The JAX recovery test's frame on the tube: the true pose's mask and
    keypoints on both captures, and a start pose perturbed on the limbs."""
    jbody, tbody = _tube_bodies()
    rng = np.random.default_rng(seed)
    limits = josm.clip_smpl_vals()
    margin = np.minimum(0.05, (limits[:, 1] - limits[:, 0]) / 4)
    pose_gt = np.clip(rng.normal(size=(72,)) * 0.1, limits[:, 0] + margin,
                      limits[:, 1] - margin).astype(np.float32)
    betas = np.zeros(10, np.float32)
    v_gt, j_gt = josm.vertex_forward(jnp.asarray(pose_gt), jnp.asarray(betas), jnp.eye(4),
                                     jbody, 1.0)
    v_gt, j_gt = np.asarray(v_gt), np.asarray(j_gt)
    jcap, tcap = _caps()
    mask = (rasterize_mesh(v_gt, np.asarray(jbody.faces), jcap)[..., 3] > 0.5).astype(np.uint8)
    k_mat = np.asarray(jcap.intrinsic_matrix)
    w2c = np.asarray(jcap.cam_pose.world_to_camera)
    img_j = (j_gt @ w2c[:3, :3].T + w2c[:3, 3]) @ k_mat.T
    img_j = img_j[:, :2] / img_j[:, 2:3]
    coco = np.zeros((17, 3))
    for s, c in tosm.COCO_OF_SMPL.items():
        coco[c] = [*img_j[s], 1.0]
    for cap in (jcap, tcap):
        cap.binary_mask, cap.keypoints, cap.densepose = mask, coco, np.arange(25)
    enabled = josm.turn_smpl_gradient_on(np.arange(25)).astype(bool)
    delta = np.zeros(72, np.float32)
    delta[enabled] = (rng.normal(size=enabled.sum()) * 0.15).astype(np.float32)
    start_margin = np.minimum(0.02, (limits[:, 1] - limits[:, 0]) / 8)
    pose_start = np.clip(pose_gt + delta, limits[:, 0] + start_margin,
                         limits[:, 1] - start_margin).astype(np.float32)
    return dict(jbody=jbody, tbody=tbody, jcap=jcap, tcap=tcap, pose_gt=pose_gt, betas=betas,
                pose_start=pose_start, enabled=enabled, v_gt=v_gt, img_j=img_j, k_mat=k_mat,
                w2c=w2c)


@pytest.fixture(scope="module")
def frame():
    return _frame_inputs()


def _jax_loss_fn(cap, frame_fit, body, align, scale, stride=4):
    """The loss of neuman_tpu.preprocess.optimize_smpl.optimize_smpl_frame
    (sil_impl="face"), composed of the JAX package's functions as it
    composes them."""
    betas = jnp.asarray(frame_fit["betas"], jnp.float32)
    align_j = jnp.asarray(align, jnp.float32)
    h, w = cap.shape
    k_mat = jnp.asarray(cap.intrinsic_matrix, jnp.float32)
    w2c = jnp.asarray(cap.cam_pose.world_to_camera, jnp.float32)
    mask_target = jnp.asarray(cap.binary_mask[::stride, ::stride], jnp.float32)
    keypoints = np.asarray(cap.keypoints, np.float64).copy()
    keypoints[keypoints[:, 2] < 0.3] = 0
    joints_target = josm.coco_to_smpl(keypoints[:, :2])
    joints_mask = jnp.asarray((joints_target.sum(axis=1) != 0).astype(np.float32))
    joints_target = jnp.asarray(joints_target, jnp.float32)
    faces = jnp.asarray(np.asarray(body.faces), jnp.int32)

    def project(pts):
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        img = cam @ k_mat.T
        return img[:, :2] / img[:, 2:3], cam[:, 2]

    def loss_fn(pose):
        verts, joints = josm.vertex_forward(pose, betas, align_j, body, scale)
        pj, _ = project(joints)
        kp = (jnp.sum(joints_mask[:, None] * (pj - joints_target) ** 2)
              / jnp.maximum(joints_mask.sum() * 2, 1.0))
        vi, vz = project(verts)
        sil = j_raster(vi, faces, h, w, sigma=1e-4, stride=stride, vert_z=vz)
        return kp + jnp.mean((sil - mask_target) ** 2)

    return jax.jit(jax.value_and_grad(loss_fn))


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


# ---------------------------------------------------------------- rasteriser


def _raster_inputs(seed=0):
    rng = np.random.default_rng(seed)
    verts = rng.uniform([-8.0, -8.0], [W + 8.0, H + 8.0], size=(30, 2)).astype(np.float32)
    faces = rng.integers(0, 30, size=(20, 3)).astype(np.int32)
    faces = np.concatenate([faces, np.full((3, 3), -1, np.int32)])  # padded rows
    vert_z = rng.uniform(1.0, 3.0, size=30).astype(np.float32)
    vert_z[faces[4, 1]] = -0.5  # two faces behind the camera
    vert_z[faces[11, 0]] = 0.0
    weights = rng.normal(size=((H + 1) // 2, (W + 1) // 2)).astype(np.float32)
    return verts, faces, vert_z, weights


@pytest.mark.parametrize("sigma", [1e-4, 1e-2])
@pytest.mark.parametrize("chunk", [512, 7])
def test_soft_rasterizer_matches_jax(chunk, sigma):
    verts, faces, vert_z, weights = _raster_inputs()

    def jloss(v):
        a = j_raster(v, jnp.asarray(faces), H, W, sigma=sigma, stride=2, face_chunk=chunk,
                     vert_z=jnp.asarray(vert_z))
        return jnp.sum(a * weights), a

    (_, j_alpha), j_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(verts))
    tv = torch.tensor(verts, requires_grad=True)
    t_alpha = t_raster(tv, torch.as_tensor(faces), H, W, sigma=sigma, stride=2, face_chunk=chunk,
                       vert_z=torch.as_tensor(vert_z))
    (t_grad,) = torch.autograd.grad((t_alpha * torch.as_tensor(weights)).sum(), tv)
    np.testing.assert_allclose(t_alpha.detach().numpy(), np.asarray(j_alpha), atol=RASTER_ATOL)
    assert _rel_l2(t_grad.numpy(), j_grad) <= RASTER_GRAD_REL
    culled = np.unique(faces[[4, 11]])
    only_culled = np.setdiff1d(culled, faces[np.setdiff1d(np.arange(20), [4, 11])])
    assert np.abs(t_grad.numpy()[only_culled]).max(initial=0.0) == 0.0


def test_soft_rasterizer_chunk_sizes_agree():
    """face_chunk changes only the order of the f32 sums, forward and
    backward; a no_grad forward equals the forward under autograd."""
    verts, faces, vert_z, weights = _raster_inputs(1)
    outs = []
    for chunk in (512, 5, 1):
        tv = torch.tensor(verts, requires_grad=True)
        a = t_raster(tv, torch.as_tensor(faces), H, W, sigma=1e-3, stride=2, face_chunk=chunk,
                     vert_z=torch.as_tensor(vert_z))
        (g,) = torch.autograd.grad((a * torch.as_tensor(weights)).sum(), tv)
        outs.append((a.detach().numpy(), g.numpy()))
    for a, g in outs[1:]:
        np.testing.assert_allclose(a, outs[0][0], atol=1e-6)
        assert _rel_l2(g, outs[0][1]) < 1e-5
    with torch.no_grad():
        a = t_raster(torch.tensor(verts), torch.as_tensor(faces), H, W, sigma=1e-3, stride=2,
                     vert_z=torch.as_tensor(vert_z))
    np.testing.assert_array_equal(a.numpy(), outs[0][0])


def test_logaddexp_softplus_is_jaxs():
    """-logaddexp(x, 0) is JAX's -softplus(x) everywhere, where torch's
    softplus turns into the identity above x = 20."""
    x = np.concatenate([np.linspace(-60, 60, 2001), [19.9, 20.0, 20.1]]).astype(np.float32)
    t = torch.logaddexp(torch.as_tensor(x), torch.zeros(()))
    np.testing.assert_allclose(t.numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- alignment


def test_ransac_plane_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-2, 2, size=(500, 2))
    ground = np.concatenate([xy, 0.5 + 0.002 * rng.normal(size=(500, 1))], axis=1)
    pts = np.concatenate([ground, rng.uniform(-2, 2, size=(150, 3))])
    for threshold, iters, seed in ((0.02, 300, 0), (0.05, 100, 7)):
        jm, ji = jalign.ransac_plane(pts, threshold, iters, seed)
        tm, ti = talign.ransac_plane(pts, threshold, iters, seed)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ti, ji)


def test_solve_scale_equals_jax():
    jcap, tcap = _caps(t_cam=(0.1, -0.3, 0.5))
    rng = np.random.default_rng(2)
    joints = rng.normal(size=(54, 3)) + [0, 0.5, 3.0]
    plane = np.array([0.05, 1.0, 0.1, -2.0])
    plane[:3] /= np.linalg.norm(plane[:3])
    assert talign.solve_scale(joints, tcap, plane) == jalign.solve_scale(joints, jcap, plane)


def test_solve_translation_matches_jax():
    """1000 Adam steps at lr 1e-3 (the alignment's) from the same f32
    inputs: within 1e-4 of JAX, and both near the true shift."""
    rng = np.random.default_rng(1)
    k = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    mvp = (k @ np.eye(4)[:3]).astype(np.float32)
    true_t = np.array([0.05, -0.08, 0.1])
    p3d = rng.uniform([-0.5, -0.5, 2.0], [0.5, 0.5, 3.0], size=(54, 3))
    cam = (p3d + true_t) @ mvp[:3, :3].T + mvp[:, 3]
    p2d = (cam[:, :2] / cam[:, 2:3]).astype(np.float32)
    p3d = p3d.astype(np.float32)
    jt = jalign.solve_translation(p3d, p2d, mvp)
    tt = talign.solve_translation(p3d, p2d, mvp, device="cpu")
    assert tt.shape == (1, 3) and tt.dtype == np.float32
    np.testing.assert_allclose(tt, jt, atol=TRANSLATION_ATOL)
    np.testing.assert_allclose(tt[0], true_t, atol=0.02)


def test_camera_pose_members_match_jax():
    q = np.array([0.9, 0.1, -0.3, 0.2])
    q /= np.linalg.norm(q)
    t = np.array([0.3, -0.2, 1.5], np.float32)
    jp, tp = JPose(JTranslation(t), JRotation(q)), TPose(TTranslation(t), TRotation(q))
    for name in ("camera_to_world_3x4", "world_to_camera_3x4", "quaternion"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    assert tp.camera_to_world_3x4.shape == tp.world_to_camera_3x4.shape == (3, 4)


# ---------------------------------------------------------------- refinement


def test_coco_to_smpl_equals_jax():
    coco = np.random.default_rng(0).normal(size=(17, 2))
    np.testing.assert_array_equal(tosm.coco_to_smpl(coco), josm.coco_to_smpl(coco))
    with pytest.raises(ValueError):
        tosm.coco_to_smpl(coco[:16])


@pytest.mark.parametrize("seed", range(6))
def test_gradient_mask_and_limits_equal_jax(seed):
    rng = np.random.default_rng(seed)
    dp = rng.choice(rng.integers(0, 25, size=rng.integers(1, 12)), size=(12, 9))
    np.testing.assert_array_equal(tosm.turn_smpl_gradient_on(dp), josm.turn_smpl_gradient_on(dp))
    np.testing.assert_array_equal(tosm.clip_smpl_vals(), josm.clip_smpl_vals())


def test_verts_transformations_concat_joints_matches_jax():
    jbody, tbody = _tube_bodies()
    rng = np.random.default_rng(4)
    pose = (rng.normal(size=(1, 72)) * 0.2).astype(np.float32)
    betas = (rng.normal(size=(1, 10)) * 0.1).astype(np.float32)
    jv, jt = jsmpl.verts_transformations(jbody, jnp.asarray(pose), jnp.asarray(betas),
                                         concat_joints=True)
    tv, tt = tsmpl.verts_transformations(tbody, torch.as_tensor(pose), torch.as_tensor(betas),
                                         concat_joints=True)
    assert tt.shape == (1, 144 + 24, 4, 4) and tv.shape == (1, 144 + 24, 3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_vertex_forward_matches_jax(frame):
    rng = np.random.default_rng(5)
    align = np.eye(4)
    align[:3, :3] = tsmpl.batch_rodrigues(torch.tensor([[0.2, -0.4, 0.3]]))[0].numpy()
    align[3, :3] = [0.3, -0.1, 0.5]
    pose = (rng.normal(size=72) * 0.2).astype(np.float32)
    betas = (rng.normal(size=10) * 0.1).astype(np.float32)
    jv, jj = josm.vertex_forward(jnp.asarray(pose), jnp.asarray(betas),
                                 jnp.asarray(align, jnp.float32), frame["jbody"], 1.3)
    tv, tj = tosm.vertex_forward(torch.as_tensor(pose), torch.as_tensor(betas),
                                 torch.as_tensor(align, dtype=torch.float32), frame["tbody"], 1.3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-5)


def test_one_step_loss_and_gated_gradient_match_jax(frame):
    fit = {"pose": frame["pose_start"], "betas": frame["betas"]}
    jl, jg = _jax_loss_fn(frame["jcap"], fit, frame["jbody"], np.eye(4), 1.0)(
        jnp.asarray(frame["pose_start"]))
    limits = josm.clip_smpl_vals()
    valid = (frame["pose_start"] < limits[:, 1]) & (frame["pose_start"] > limits[:, 0])
    jg = np.asarray(jg) * josm.turn_smpl_gradient_on(np.arange(25)) * valid
    refiner = tosm.FrameRefiner(frame["tcap"], fit, frame["tbody"], np.eye(4), 1.0, device="cpu")
    tl, tg = refiner.gated_grad(refiner.pose0)
    assert abs(float(tl) - float(jl)) <= STEP_LOSS_REL * abs(float(jl))
    assert _rel_l2(tg.numpy(), jg) <= STEP_GRAD_REL
    assert np.all(tg.numpy()[~frame["enabled"]] == 0)


def test_twenty_steps_match_jax(frame):
    fit = {"pose": frame["pose_start"], "betas": frame["betas"]}
    jp = josm.optimize_smpl_frame(frame["jcap"], fit, frame["jbody"], np.eye(4), 1.0,
                                  num_iters=20)
    tp = tosm.optimize_smpl_frame(frame["tcap"], fit, frame["tbody"], np.eye(4), 1.0,
                                  num_iters=20, device="cpu")
    assert tp.dtype == np.float32 and tp.shape == (72,)
    np.testing.assert_allclose(tp, jp, atol=POSE20_ATOL)
    assert np.abs(tp - frame["pose_start"]).max() > 10 * POSE20_ATOL


def test_splat_silhouette_matches_jax():
    rng = np.random.default_rng(6)
    vi = rng.uniform([0, 0], [W, H], size=(40, 2)).astype(np.float32)
    j = josm.soft_silhouette(jnp.asarray(vi), None, H, W, stride=2)
    t = tosm.soft_silhouette(torch.as_tensor(vi), H, W, stride=2)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_refinement_recovers_a_perturbed_pose(frame):
    """tests/test_preprocess.py's recovery check on the port: 400 steps at
    lr 2e-3 from limb components perturbed by N(0, 0.15)."""
    tbody, betas = frame["tbody"], frame["betas"]

    def metrics(pose):
        with torch.no_grad():
            v, j = tosm.vertex_forward(torch.as_tensor(pose), torch.as_tensor(betas),
                                       torch.eye(4), tbody, 1.0)
        v, j = v.numpy(), j.numpy()
        pj = (j @ frame["w2c"][:3, :3].T + frame["w2c"][:3, 3]) @ frame["k_mat"].T
        pj = pj[:, :2] / pj[:, 2:3]
        mapped = sorted(tosm.COCO_OF_SMPL)
        return (np.linalg.norm(v - frame["v_gt"], axis=1).mean(),
                np.linalg.norm(pj[mapped] - frame["img_j"][mapped], axis=1).mean())

    refined = tosm.optimize_smpl_frame(
        frame["tcap"], {"pose": frame["pose_start"], "betas": betas}, tbody, np.eye(4), 1.0,
        num_iters=400, lr=2e-3, device="cpu")
    v0, k0 = metrics(frame["pose_start"])
    v1, k1 = metrics(refined)
    np.testing.assert_allclose(refined[~frame["enabled"]], frame["pose_start"][~frame["enabled"]],
                               atol=1e-6)
    assert v1 < 0.4 * v0, f"vertex error not recovered: {v0:.4f} -> {v1:.4f}"
    assert k1 < 0.2 * k0, f"keypoint error not recovered: {k0:.2f} -> {k1:.2f}"


def test_entry_points_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.run_alignment(str(tmp_path), str(tmp_path), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.run_optimize_smpl(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        talign.solve_translation(np.zeros((5, 3)), np.zeros((5, 2)), np.eye(4)[:3])


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """Both packages' stage 9 then stage 10 (3 steps a frame) on copies of
    one 4-frame 48x64 preprocessing scene; stage 9's pickle lands where
    stage 10 reads it in both (ROMP's directory inside the scene)."""
    root = tmp_path_factory.mktemp("preprocess")
    scene, truth = write_preprocess_inputs(str(root / "src"), num_frames=4, h=H, w=W)
    data_root = os.path.join(str(root / "src"), "data")
    old = os.environ.get("NEUMAN_DATA_ROOT")
    os.environ["NEUMAN_DATA_ROOT"] = data_root
    out = {"truth": truth}
    try:
        for name, cli, kw in (("jax", jcli, {}), ("port", tcli, {"device": "cpu"})):
            d = str(root / name)
            shutil.copytree(scene, d)
            a = cli.run_alignment(os.path.join(d, "sparse"), os.path.join(d, "images"),
                                  os.path.join(d, "romp"), **kw)
            cli.run_optimize_smpl(d, num_iters=3, **kw)
            out[name] = (d, a)
    finally:
        if old is None:
            os.environ.pop("NEUMAN_DATA_ROOT")
        else:
            os.environ["NEUMAN_DATA_ROOT"] = old
    return out


# alignments.npy: port vs JAX, both vs the truth, over each matrix's largest
# entry. The two differ by the EPnP (~1e-8) carried through 1000 f32 Adam
# steps of the translation; the truth by those steps' final wobble (lr 1e-3)
ALIGN_REL_JAX, ALIGN_REL_TRUTH = 1e-4, 1e-2
# the optimised poses after 3 steps (radians)
SLICE_POSE_ATOL = 1e-4


def test_slice_alignments_match_jax_and_the_truth(slice_runs):
    (jd, ja), (td, ta) = slice_runs["jax"], slice_runs["port"]
    on_disk = {k: np.load(os.path.join(d, "alignments.npy"), allow_pickle=True).item()
               for k, d in (("jax", jd), ("port", td))}
    truth = slice_runs["truth"]["alignments"]
    assert sorted(on_disk["port"]) == sorted(on_disk["jax"]) == sorted(truth)
    for name, a in on_disk["port"].items():
        assert a.shape == (4, 3)
        np.testing.assert_array_equal(a, ta[name])
        scale = np.abs(truth[name]).max()
        assert np.abs(a - on_disk["jax"][name]).max() <= ALIGN_REL_JAX * scale
        assert np.abs(a - truth[name]).max() <= ALIGN_REL_TRUTH * scale


def test_slice_poses_match_jax_and_pickles_cross_read(slice_runs):
    (jd, _), (td, _) = slice_runs["jax"], slice_runs["port"]
    for kind in ("romp", "optimized"):
        jpath = os.path.join(jd, f"smpl_output_{kind}.pkl")
        tpath = os.path.join(td, f"smpl_output_{kind}.pkl")
        j_by_port, t_by_joblib = smpl_pickle.load(jpath), joblib.load(tpath)
        assert list(j_by_port) == list(t_by_joblib) == [1]
        j_fits, t_fits = j_by_port[1], t_by_joblib[1]
        assert sorted(j_fits) == sorted(t_fits)
        for key in j_fits:
            np.testing.assert_array_equal(joblib.load(jpath)[1][key], j_fits[key])
            np.testing.assert_array_equal(smpl_pickle.load(tpath)[1][key], t_fits[key])
            atol = SLICE_POSE_ATOL if (kind, key) == ("optimized", "pose") else 1e-6
            np.testing.assert_allclose(t_fits[key], j_fits[key], atol=atol)
    t_opt = smpl_pickle.load(os.path.join(td, "smpl_output_optimized.pkl"))[1]["pose"]
    assert np.abs(t_opt - slice_runs["truth"]["romp_pose"]).max() > 10 * SLICE_POSE_ATOL


def test_both_readers_read_both_stage_outputs(slice_runs):
    """Each package's scene reader takes the other's alignments and fits."""
    from neuman_tpu.data_io.neuman import NeuManReader as JReader
    from neuman_tpu_torch.data_io.neuman import NeuManReader as TReader

    (jd, _), (td, _) = slice_runs["jax"], slice_runs["port"]
    smpl_path = os.path.join(os.path.dirname(jd), "src", "data", "smplx", "smpl",
                             "SMPL_NEUTRAL.pkl")
    j_scene = JReader.read_scene(td, smpl_type="optimized", smpl_model_path=smpl_path)
    t_scene = TReader.read_scene(jd, smpl_type="optimized", smpl_model_path=smpl_path)
    for jv, tv in zip(j_scene.verts, t_scene.verts):
        np.testing.assert_allclose(np.asarray(tv), np.asarray(jv), atol=1e-3)


def test_smpl_pickle_dump_reads_back(tmp_path):
    fits = {1: {"pose": np.arange(144, dtype=np.float32).reshape(2, 72),
                "betas": np.ones((2, 10), np.float32)}}
    path = str(tmp_path / "fits.pkl")
    smpl_pickle.dump(fits, path)
    for loaded in (smpl_pickle.load(path), joblib.load(path)):
        assert list(loaded) == [1]
        for k, v in fits[1].items():
            np.testing.assert_array_equal(loaded[1][k], v)
            assert loaded[1][k].dtype == v.dtype


# ---------------------------------------------------------------- gen_run


def _run_sh(tmp_path):
    video = str(tmp_path / "videos" / "bike.mp4")
    subprocess.run([sys.executable, "-m", "neuman_tpu_torch.preprocess.gen_run", "--video", video],
                   cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO}, check=True,
                   capture_output=True, timeout=120)
    with open(tmp_path / "run.sh") as f:
        return video, f.read().splitlines()


def test_gen_run_calls_only_the_port(tmp_path):
    _, lines = _run_sh(tmp_path)
    commands = [ln for ln in lines if ln and not ln.startswith("#")]
    python = [ln for ln in commands if ln.startswith("python")]
    assert len(python) == 2  # stages 9 and 10; stage 1 is a comment now
    assert all("neuman_tpu_torch.preprocess.cli" in ln for ln in python)
    code = "\n".join(commands).replace("neuman_tpu_torch", "")
    assert "neuman_tpu" not in code
    assert sum("/10:" in ln for ln in lines) == 10


def test_gen_run_stage_9_pickle_is_stage_10_input(tmp_path):
    video, lines = _run_sh(tmp_path)
    scene, out, romp = tgen.scene_paths(video)
    align = next(ln for ln in lines if "run_alignment(" in ln)
    optimize = next(ln for ln in lines if "run_optimize_smpl(" in ln)
    sparse_dir, images_dir, romp_dir = align.split("run_alignment(")[1].split(")")[0].replace(
        "'", "").split(", ")
    scene_dir = optimize.split("run_optimize_smpl(")[1].split(")")[0].strip("'")
    assert romp_dir == romp and f"# ROMP -> {romp} (external tool)" in lines
    assert tcli.romp_pickle_path(romp_dir) == os.path.join(scene_dir, "smpl_output_romp.pkl")
    assert os.path.dirname(sparse_dir) == scene_dir == out
    # the JAX generator's paths, for contrast: its stage 9 pickle is not
    # where its stage 10 reads
    from neuman_tpu.preprocess import gen_run as jgen

    j_lines = jgen.build_commands(type("Opt", (), {"video": video})())
    j_romp = next(ln for ln in j_lines if "run_alignment(" in ln).split("', '")[-1].split("'")[0]
    assert tcli.romp_pickle_path(j_romp) != os.path.join(out, "smpl_output_romp.pkl")
