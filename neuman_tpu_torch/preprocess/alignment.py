"""SMPL <-> COLMAP scene alignment (preprocessing stage 9; the port's
counterpart of neuman_tpu/preprocess/alignment.py).

Per frame: the SMPL camera from ROMP's 3D joints and their 2D projections
by EPnP in RANSAC (`pnp.py`, in place of cv2); a translation refined for
1000 Adam steps on the reprojection MSE (torch autograd and optax.adam's
rule, on the device); the metric scale where the camera -> joint rays
meet the RANSAC ground plane of the COLMAP points; the 4x3 alignment
(world = [p, 1] @ A), saved as `alignments.npy` {image name: A}.
"""

import copy
import os

import numpy as np
import torch

from neuman_tpu_torch.cameras.pose import CameraPose
from neuman_tpu_torch.geometry import transforms
from neuman_tpu_torch.geometry.rotation import Rotation, Translation
from neuman_tpu_torch.ops.precision import no_tf32
from neuman_tpu_torch.preprocess.pnp import solve_pnp_ransac
from neuman_tpu_torch.trainers.background import ScaleByAdam
from neuman_tpu_torch.train import require_device


def to_homogeneous(pts):
    return np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)


def ransac_plane(points, distance_threshold=0.02, num_iterations=1000, seed=0):
    """((a, b, c, d) with |(a, b, c)| = 1, inlier indices): the plane of
    the most points within `distance_threshold`, refined by the SVD of its
    inliers (open3d's segment_plane; the JAX package's draws and
    arithmetic, so the result is bit-equal)."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(points[:, :3], dtype=np.float64)
    n = len(pts)
    best_count = -1
    best_model = None
    for _ in range(num_iterations):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = pts[idx]
        normal = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(normal)
        if norm < 1e-12:
            continue
        normal = normal / norm
        d = -np.dot(normal, p0)
        dist = np.abs(pts @ normal + d)
        count = int((dist < distance_threshold).sum())
        if count > best_count:
            best_count = count
            best_model = np.array([*normal, d])
    if best_model is None:
        raise ValueError("plane RANSAC found no plane: every sample was degenerate")
    inliers = np.abs(pts @ best_model[:3] + best_model[3]) < distance_threshold
    sel = pts[inliers]
    centroid = sel.mean(axis=0)
    _, _, vh = np.linalg.svd(sel - centroid)
    normal = vh[-1]
    d = -np.dot(normal, centroid)
    return np.array([*normal, d]), np.where(inliers)[0]


def solve_translation(p3d, p2d, mvp, total_iters=1000, lr=1e-3, device="cuda"):
    """[1, 3] translation of the points p3d [N, 3] that minimises the MSE
    of their projections through mvp [3, 4] against p2d [N, 2]: Adam from
    zero, float32, on `device`."""
    require_device(device, "solve_translation")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    p3d, p2d, mvp = f32(np.asarray(p3d)[:, :3]), f32(p2d), f32(mvp)
    t = torch.zeros((1, 3), device=device)
    named = {"t": {"t": t}}
    adam = ScaleByAdam()
    state = adam.init(named)
    keep = torch.zeros((), dtype=torch.bool, device=device)
    ones = torch.ones_like(p3d[:, :1])
    with no_tf32():
        for _ in range(total_iters):
            tt = t.detach().requires_grad_(True)
            cam = torch.cat([p3d + tt, ones], dim=1) @ mvp.T
            loss = torch.mean((cam[:, :2] / cam[:, 2:3] - p2d) ** 2)
            (g,) = torch.autograd.grad(loss, tt)
            adam.step(named, {"t": {"t": g}}, state, lr, keep)
    return t.cpu().numpy()


def solve_scale(joints_world, cap, plane_model):
    """The least positive scale about the camera centre that puts a joint
    on the plane (a, b, c, d)."""
    cam_center = cap.cam_pose.camera_center_in_world
    a, b, c, d = plane_model
    right = -(a * cam_center[0] + b * cam_center[1] + c * cam_center[2] + d)
    scales = []
    for j in joints_world:
        coe = (a * (j[0] - cam_center[0]) + b * (j[1] - cam_center[1])
               + c * (j[2] - cam_center[2]))
        s = right / coe
        if s > 0:
            scales.append(s)
    if not scales:
        raise ValueError("no camera -> joint ray meets the ground plane in front of the camera")
    return min(scales)


def solve_transformation(verts, j3d, j2d, plane_model, colmap_cap, smpl_cap, device="cuda"):
    """(alignment [4, 3], world vertices [V, 3]) of one frame; moves
    smpl_cap's camera centre by the refined translation."""
    mvp = np.matmul(smpl_cap.intrinsic_matrix, smpl_cap.extrinsic_matrix)
    trans = solve_translation(j3d, j2d, mvp, device=device)
    smpl_cap.cam_pose.camera_center_in_world = (
        smpl_cap.cam_pose.camera_center_in_world - trans[0])
    joints_world = (to_homogeneous(j3d) @ smpl_cap.cam_pose.world_to_camera.T
                    @ colmap_cap.cam_pose.camera_to_world.T)[:, :3]
    scale = solve_scale(joints_world, colmap_cap, plane_model)
    transf = smpl_cap.cam_pose.world_to_camera.T * scale
    transf[3, 3] = 1
    transf = transf @ colmap_cap.cam_pose.camera_to_world_3x4.T
    verts_world = to_homogeneous(verts) @ transf
    return transf, verts_world


def export_alignments(scene, raw_smpl, save_path, plane_threshold=0.02, device="cuda"):
    """Solve each frame's alignment and write `alignments.npy`.

    scene: a ColmapAsciiReader scene in video order; raw_smpl: 'verts',
    'joints3d' and 'joints2d_img_coord' arrays, one entry per frame.
    """
    plane_model, _ = ransac_plane(scene.point_cloud[:, :3], plane_threshold)
    alignments = {}
    for i, cap in enumerate(scene.captures):
        r_mat, t, _ = solve_pnp_ransac(raw_smpl["joints3d"][i], raw_smpl["joints2d_img_coord"][i],
                                       cap.pinhole_cam.intrinsic_matrix)
        quat = transforms.quaternion_from_matrix(r_mat).astype(np.float32)
        smpl_cap = copy.deepcopy(cap)
        smpl_cap.cam_pose = CameraPose(Translation(t.astype(np.float32)), Rotation(quat))
        transf, _ = solve_transformation(raw_smpl["verts"][i], raw_smpl["joints3d"][i],
                                         raw_smpl["joints2d_img_coord"][i], plane_model, cap,
                                         smpl_cap, device=device)
        alignments[os.path.basename(cap.image_path)] = transf
    np.save(save_path, alignments)
    return alignments
