"""The canonical 360-degree cameras of the human stage's validation, in
numpy: the path of render/paths.py about the canonical body's spine
(utils/misc.py `smpl_verts_to_center_and_up`) with the canonical
intrinsics of the JAX HumanNeRFTrainer."""

import types

import numpy as np

from neuman_tpu_torch.render.paths import default_360_path
from neuman_tpu_torch.utils.constants import CANONICAL_CAMERA_DIST, CANONICAL_ZOOM_FACTOR
from neuman_tpu_torch.utils.misc import smpl_verts_to_center_and_up


def canonical_cameras(static_vert, body_model, hw, res=100):
    """(intrinsics [res, 3, 3], camera-to-world [res, 4, 4]) f32 of the
    canonical cameras for a body with canonical vertices `static_vert` and
    SMPL-like `body_model`, and images of `hw` = (height, width)."""
    center, up = smpl_verts_to_center_and_up(static_vert, body_model)
    poses = default_360_path(center, up, CANONICAL_CAMERA_DIST, res)
    h, w = hw
    f = CANONICAL_ZOOM_FACTOR * w
    k = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]], np.float32)
    return np.tile(k[None], (res, 1, 1)), np.stack([p.camera_to_world for p in poses]).astype(
        np.float32)


def canonical_capture(k, c2w, hw):
    """One canonical camera as the capture the renderers read: .shape,
    .intrinsic_matrix, .cam_pose.camera_to_world."""
    return types.SimpleNamespace(shape=tuple(hw), intrinsic_matrix=np.asarray(k),
                                 cam_pose=types.SimpleNamespace(camera_to_world=np.asarray(c2w)))
