"""The canonical 360-degree cameras of the human stage, in numpy: the
port's copies of neuman_tpu/render/paths.py (`pose_spherical`,
`default_360_path`), neuman_tpu/utils/misc.py `smpl_verts_to_center_and_up`
and the canonical intrinsics of the JAX HumanNeRFTrainer."""

import math
import types

import numpy as np

from neuman_tpu_torch.utils.constants import CANONICAL_CAMERA_DIST, CANONICAL_ZOOM_FACTOR


def _rotation_matrix(angle, direction):
    """4x4 rotation by `angle` radians about the axis `direction`."""
    d = np.asarray(direction[:3], np.float64)
    d = d / np.linalg.norm(d)
    sina, cosa = math.sin(angle), math.cos(angle)
    r = np.eye(3) * cosa + np.outer(d, d) * (1.0 - cosa)
    r += sina * np.array([[0.0, -d[2], d[1]], [d[2], 0.0, -d[0]], [-d[1], d[0], 0.0]])
    m = np.eye(4)
    m[:3, :3] = r
    return m


def pose_spherical(theta, phi, radius):
    """Camera-to-world of a camera on a sphere, looking at its centre."""
    th, ph = theta / 180.0 * np.pi, phi / 180.0 * np.pi
    c2w = np.eye(4)
    c2w[2, 3] = radius
    rot_phi = np.eye(4)
    rot_phi[1, 1], rot_phi[1, 2], rot_phi[2, 1], rot_phi[2, 2] = (
        np.cos(ph), -np.sin(ph), np.sin(ph), np.cos(ph))
    rot_theta = np.eye(4)
    rot_theta[0, 0], rot_theta[0, 2], rot_theta[2, 0], rot_theta[2, 2] = (
        np.cos(th), -np.sin(th), np.sin(th), np.cos(th))
    c2w = rot_theta @ rot_phi @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]]) @ c2w
    return c2w @ np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])


def default_360_path(center, up, dist, res=40, rad=360):
    """`res` camera-to-world matrices on a circle of radius `dist` around
    `center`, in the plane normal to `up`."""
    up = np.asarray(up, np.float64)
    up2 = np.array([0.0, 0.0, 1.0])
    cos = np.clip(np.dot(up, up2) / (np.linalg.norm(up) * np.linalg.norm(up2)), -1.0, 1.0)
    rot = _rotation_matrix(-math.acos(cos), np.cross(up, up2))
    trans = np.eye(4)
    trans[:3, 3] = np.asarray(center)[:3]
    return [trans @ rot @ pose_spherical(a, 0, dist)
            for a in np.linspace(-rad / 2, rad / 2, res + 1)[:-1]]


def smpl_verts_to_center_and_up(verts, j_regressor):
    """Centre and up direction of a body from the SVD of its spine joints
    (joints 0, 3, 6, 9 of j_regressor [J, V] applied to verts [V, 3])."""
    joints = np.asarray(j_regressor, np.float32) @ np.asarray(verts, np.float32)
    spine = joints[[0, 3, 6, 9]]
    center = spine.mean(axis=0)
    _, _, vv = np.linalg.svd(spine - center)
    linepts = vv[0] * np.mgrid[-7:7:2j][:, np.newaxis] + center
    up = linepts[1] - linepts[0]
    if np.dot(spine[3] - spine[0], up) < 0:
        up = -up
    return center, up / np.linalg.norm(up)


def canonical_cameras(static_vert, j_regressor, hw, res=100):
    """(intrinsics [res, 3, 3], camera-to-world [res, 4, 4]) f32 of the
    canonical cameras for a body with canonical vertices `static_vert` and
    images of `hw` = (height, width)."""
    center, up = smpl_verts_to_center_and_up(static_vert, j_regressor)
    poses = default_360_path(center, up, CANONICAL_CAMERA_DIST, res)
    h, w = hw
    f = CANONICAL_ZOOM_FACTOR * w
    k = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]], np.float32)
    return np.tile(k[None], (res, 1, 1)), np.stack(poses).astype(np.float32)


def canonical_capture(k, c2w, hw):
    """One canonical camera as the capture the renderers read: .shape,
    .intrinsic_matrix, .cam_pose.camera_to_world."""
    return types.SimpleNamespace(shape=tuple(hw), intrinsic_matrix=np.asarray(k),
                                 cam_pose=types.SimpleNamespace(camera_to_world=np.asarray(c2w)))
