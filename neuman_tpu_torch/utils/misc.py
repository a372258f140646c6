"""Host-side scene helpers (the port's copy of the numpy branches of
neuman_tpu/utils/misc.py and neuman_tpu/native_bridge.py)."""

import numpy as np
import torch
from scipy import ndimage

from neuman_tpu_torch.models import smpl as smpl_module


def print_notification(content_list, notification_type="NOTIFICATION"):
    print(f"---------------------- {notification_type} ----------------------")
    for content in content_list:
        print(content)
    print("----------------------------------------------------")


def add_border_mask(scene, iterations=10):
    """Give every capture a `border_mask`: the ring that `iterations`
    dilations by the 4-connected cross add around its binary mask."""
    for cap in scene.captures:
        mask = cap.binary_mask
        if iterations > 0:
            dilated = ndimage.binary_dilation(np.ascontiguousarray(mask, np.uint8),
                                              iterations=iterations)
            cap.border_mask = dilated.astype(np.uint8).astype(mask.dtype) - mask
        else:
            cap.border_mask = mask - mask


def fused_depth(mvs, mono, mask):
    """`mvs` with its holes (depth 0, or on the human) filled by
    slope * mono + intercept, the line fitted by least squares to
    (mono, mvs) on the valid pixels. Raises ValueError on fewer than 2
    valid pixels."""
    valid = (mvs > 0) & (mask == 0)
    if valid.sum() < 2:
        raise ValueError("degenerate mono->mvs depth fit: fewer than 2 valid pixels")
    slope, intercept = np.polyfit(mono[valid], mvs[valid], 1)
    out = mvs.copy()
    out[~valid] = mono[~valid] * slope + intercept
    return out


def smpl_verts_to_center_and_up(verts, body_model=None):
    """Centre and up direction of a body with vertices `verts` [V, 3]: the
    line fitted by SVD through its spine joints (0, 3, 6, 9 of the body
    model's J_regressor, f32), pointing from the pelvis to the chest. The
    body model is the scene reader's when none is given."""
    if body_model is None:
        from neuman_tpu_torch.data_io.neuman import NeuManReader

        body_model = NeuManReader._body_model()
    v = torch.as_tensor(np.asarray(verts, np.float32), device=body_model.J_regressor.device)
    joints = smpl_module.vertices2joints(body_model.J_regressor, v[None])[0].cpu().numpy()
    spine = joints[[0, 3, 6, 9]]
    center = spine.mean(axis=0)
    _, _, vv = np.linalg.svd(spine - center)
    linepts = vv[0] * np.mgrid[-7:7:2j][:, np.newaxis]
    linepts += center
    up = linepts[1] - linepts[0]
    if np.dot(spine[3] - spine[0], up) < 0:
        up = linepts[0] - linepts[1]
    up /= np.linalg.norm(up)
    return center, up
