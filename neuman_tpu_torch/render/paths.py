"""Camera paths of the 360-degree renders (the port's copy of
neuman_tpu/render/paths.py; numpy float64): `pose_spherical` places a
camera on a sphere looking at its centre; `default_360_path` puts `res` of
them on a circle about a body's centre in the plane normal to its up
direction. Both return CameraPose objects built as the JAX package builds
them, so that a rendered camera equals the JAX one."""

import numpy as np

from neuman_tpu_torch.cameras.pose import CameraPose
from neuman_tpu_torch.geometry import transforms


def _trans_t(t):
    m = np.eye(4)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4)
    m[1, 1] = np.cos(phi)
    m[1, 2] = -np.sin(phi)
    m[2, 1] = np.sin(phi)
    m[2, 2] = np.cos(phi)
    return m


def _rot_theta(th):
    m = np.eye(4)
    m[0, 0] = np.cos(th)
    m[0, 2] = -np.sin(th)
    m[2, 0] = np.sin(th)
    m[2, 2] = np.cos(th)
    return m


def pose_spherical(theta, phi, radius):
    """The camera at azimuth `theta` and elevation `phi` (degrees) on a
    sphere of `radius`, looking at its centre."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]]) @ c2w
    c2w = c2w @ np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])
    return CameraPose.from_camera_to_world(c2w, unstable=True)


def default_360_path(center, up, dist, res=40, rad=360):
    """`res` cameras at distance `dist` from `center`, evenly spaced over
    `rad` degrees about the axis `up`."""
    up2 = np.array([0, 0, 1])
    rot = transforms.rotation_matrix(-transforms.angle_between_vectors(up, up2),
                                     np.cross(up, up2))
    trans = transforms.translation_matrix(center)
    poses = [pose_spherical(a, 0, dist) for a in np.linspace(-rad / 2, rad / 2, res + 1)[:-1]]
    return [CameraPose.from_camera_to_world(trans @ rot @ p.camera_to_world) for p in poses]
