"""Minimal mesh rasteriser for the SMPL validation overlay, in numpy on the
host: the port's copy of neuman_tpu/render/rasterize.py. Z-buffered
barycentric triangle rasterisation with Lambertian shading, alpha-composited
over the frame. Visualisation only: on no training or render hot path.
"""

import numpy as np


def rasterize_mesh(verts_world, faces, cap, light_dir=(0.3, 0.3, -1.0),
                   base_color=(0.8, 0.8, 0.85), vert_colors=None):
    """Rasterise a triangle mesh seen from `cap` (duck-typed: .shape,
    .intrinsic_matrix, .cam_pose.world_to_camera).

    verts_world: [V, 3]; faces: [F, 3]. Returns rgba float image [H, W, 4].
    vert_colors [V, 3] switches from camera-space Lambertian shading to
    barycentric-interpolated VIEW-CONSISTENT vertex colors (used to
    generate photometric ground truth for the synthetic quality gate).
    """
    h, w = cap.shape
    k = np.asarray(cap.intrinsic_matrix)
    w2c = np.asarray(cap.cam_pose.world_to_camera)

    v_cam = verts_world @ w2c[:3, :3].T + w2c[:3, 3]
    z = v_cam[:, 2]
    uv = v_cam @ k.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = uv[:, :2] / uv[:, 2:3]

    light = np.asarray(light_dir, dtype=np.float64)
    light /= np.linalg.norm(light)
    base = np.asarray(base_color)

    zbuf = np.full((h, w), np.inf)
    color = np.zeros((h, w, 3))
    alpha = np.zeros((h, w))

    tri_uv = uv[faces]  # [F, 3, 2]
    tri_z = z[faces]  # [F, 3]
    tri_cam = v_cam[faces]  # [F, 3, 3]
    tri_col = None if vert_colors is None else np.asarray(vert_colors)[faces]

    # face normals + shading in camera space
    n = np.cross(tri_cam[:, 1] - tri_cam[:, 0], tri_cam[:, 2] - tri_cam[:, 0])
    n_norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(n_norm, 1e-12)
    shade = 0.35 + 0.65 * np.abs(n @ light)

    # visibility: all verts in front of the camera
    visible = (tri_z > 1e-6).all(axis=1)
    xmin = np.clip(np.floor(tri_uv[:, :, 0].min(axis=1)).astype(int), 0, w - 1)
    xmax = np.clip(np.ceil(tri_uv[:, :, 0].max(axis=1)).astype(int), 0, w - 1)
    ymin = np.clip(np.floor(tri_uv[:, :, 1].min(axis=1)).astype(int), 0, h - 1)
    ymax = np.clip(np.ceil(tri_uv[:, :, 1].max(axis=1)).astype(int), 0, h - 1)

    for f in np.nonzero(visible)[0]:
        x0, x1 = xmin[f], xmax[f]
        y0, y1 = ymin[f], ymax[f]
        if x1 < x0 or y1 < y0:
            continue
        a, b, c = tri_uv[f]
        det = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])
        if abs(det) < 1e-12:
            continue
        xs, ys = np.meshgrid(
            np.arange(x0, x1 + 1), np.arange(y0, y1 + 1)
        )
        px = xs.astype(np.float64) - a[0]
        py = ys.astype(np.float64) - a[1]
        l1 = ((c[1] - a[1]) * px - (c[0] - a[0]) * py) / det
        l2 = (-(b[1] - a[1]) * px + (b[0] - a[0]) * py) / det
        l0 = 1.0 - l1 - l2
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        zi = l0 * tri_z[f, 0] + l1 * tri_z[f, 1] + l2 * tri_z[f, 2]
        sub_z = zbuf[y0 : y1 + 1, x0 : x1 + 1]
        upd = inside & (zi < sub_z)
        sub_z[upd] = zi[upd]
        if tri_col is None:
            color[y0 : y1 + 1, x0 : x1 + 1][upd] = base * shade[f]
        else:
            ci = (
                l0[..., None] * tri_col[f, 0]
                + l1[..., None] * tri_col[f, 1]
                + l2[..., None] * tri_col[f, 2]
            )
            color[y0 : y1 + 1, x0 : x1 + 1][upd] = ci[upd]
        alpha[y0 : y1 + 1, x0 : x1 + 1][upd] = 1.0
    return np.concatenate([color, alpha[..., None]], axis=-1)


def overlay_smpl(img, verts, faces, cap, opacity=0.8):
    """Alpha-composite the shaded mesh over the uint8 frame `img`."""
    rgba = rasterize_mesh(np.asarray(verts), np.asarray(faces[:, :3]), cap)
    a = rgba[..., 3:4] * opacity
    out = img.astype(np.float64) / 255.0 * (1 - a) + rgba[..., :3] * a
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
