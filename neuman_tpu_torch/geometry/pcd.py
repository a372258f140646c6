"""Point cloud <-> image projection on the host (the port's copy of
neuman_tpu/geometry/pcd.py, numpy float64 products as there, so that the
scene reader's near/far planes agree bit for bit): unprojection of pixels
with depth, or of a whole depth map, to 3-D; projection of a world point
cloud into a capture; a z-sorted splat of projected points onto a canvas."""

import numpy as np


def pcd_2d_to_pcd_3d(pcd, depth, intrinsic, cam2world=None):
    """Unproject pixels with depth: pcd [N, 2+F] pixel x, y (and features),
    depth [N, 1], intrinsic 3x3 -> [M, 3+F] camera points (world points with
    cam2world 4x4) of the pixels with depth > 0, their features after."""
    if pcd.ndim != 2 or pcd.shape[1] < 2:
        raise ValueError(f"a 2-D point cloud is [N, 2+F], not {pcd.shape}")
    if depth.shape != (pcd.shape[0], 1) or intrinsic.shape != (3, 3):
        raise ValueError(f"depth {depth.shape} must be [N, 1], intrinsic {intrinsic.shape} 3x3")
    x, y, z = pcd[:, 0], pcd[:, 1], depth[:, 0]
    xyz = np.stack([x, y, np.ones_like(x)], axis=1)
    xyz = (np.linalg.inv(intrinsic) @ xyz.T).T * z[..., None]
    in_front = xyz[:, 2] > 0
    xyz = xyz[in_front]
    feats = pcd[:, 2:][in_front]
    if cam2world is not None:
        if cam2world.shape != (4, 4):
            raise ValueError(f"cam2world is 4x4, not {cam2world.shape}")
        xyzw = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=1)
        xyzw = (cam2world @ xyzw.T).T
        finite = xyzw[:, 3] != 0
        xyzw = xyzw[finite]
        xyzw /= xyzw[:, 3:4]
        xyz, feats = xyzw[:, :3], feats[finite]
    return np.concatenate([xyz, feats], axis=1) if pcd.shape[1] > 2 else xyz


def img_to_pcd_3d(depth, intrinsic, img=None, cam2world=None):
    """Unproject a depth map [H, W] (with the image's [H, W, C] values as
    features): `pcd_2d_to_pcd_3d` of its pixels with depth > 0."""
    if depth.ndim != 2:
        raise ValueError(f"a depth map is [H, W], not {depth.shape}")
    h, w = depth.shape
    x, y = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    z = depth.reshape(-1)
    valid = z > 0
    xy = np.stack([x.reshape(-1), y.reshape(-1)], axis=1)[valid]
    if img is not None:
        if img.shape[:2] != depth.shape:
            raise ValueError(f"image {img.shape} does not match depth {depth.shape}")
        xy = np.concatenate([xy, img.reshape(-1, img.shape[-1])[valid]], axis=1)
    return pcd_2d_to_pcd_3d(xy, z[valid][:, None], intrinsic, cam2world=cam2world)


def pcd_3d_to_pcd_2d(pcd, intrinsic, extrinsic, size):
    """[M, 3+F] pixel x, y, camera z and the features of the points of `pcd`
    [N, 3+F] in front of the camera (`intrinsic` 3x3, `extrinsic` the 3x4
    world-to-camera) whose projection falls inside an image of `size`
    (H, W), less its last row and column."""
    if pcd.ndim != 2 or pcd.shape[1] < 3:
        raise ValueError(f"a point cloud is [N, 3+F], not {pcd.shape}")
    xyzw = np.concatenate([pcd[:, :3], np.ones_like(pcd[:, :1])], axis=1)
    cam_pts = ((intrinsic @ extrinsic) @ xyzw.T).T
    in_front = cam_pts[:, 2] > 0.0
    cam_pts = cam_pts[in_front]
    img_pts = (cam_pts / cam_pts[:, 2:3])[:, :2]
    inside = ((img_pts[:, 0] >= 0) & (img_pts[:, 0] < size[1] - 1)
              & (img_pts[:, 1] >= 0) & (img_pts[:, 1] < size[0] - 1))
    return np.concatenate([img_pts[inside], cam_pts[inside][:, 2:3],
                           pcd[in_front][inside][:, 3:]], axis=1)


def pcd_2d_to_img(pcd, size, has_z=False, keep_z=False):
    """Splat a 2-D point cloud [N, 2(+1 z)+F] onto a canvas of `size` (H, W)
    at its rounded, clamped pixels: its features ([H, W, F]), or ones where
    it has none ([H, W, 1]). has_z: the nearest point wins a pixel (points
    drawn far to near), and its z stays a channel only with keep_z."""
    if pcd.ndim != 2 or pcd.shape[-1] < 2:
        raise ValueError(f"a 2-D point cloud is [N, 2+F], not {pcd.shape}")
    if has_z:
        pcd = pcd[pcd[:, 2].argsort()[::-1]]
        if not keep_z:
            pcd = np.delete(pcd, [2], axis=1)
    idx = np.round(pcd[:, :2]).astype(np.int32)
    idx[:, 0] = np.clip(idx[:, 0], 0, size[1] - 1)
    idx[:, 1] = np.clip(idx[:, 1], 0, size[0] - 1)
    h, w, c = *size, pcd.shape[-1] - 2
    canvas = np.zeros((h, w, max(c, 1)))
    canvas[idx[:, 1], idx[:, 0]] = pcd[:, 2:] if c else 1.0
    return canvas


def project_point_cloud_at_capture(point_cloud, capture, render_type="pcd"):
    """A world point cloud projected at `capture` (duck-typed:
    .intrinsic_matrix, .extrinsic_matrix, .size). render_type "pcd" (the
    default here, the JAX function's is "rgb"): the [M, 3] pixel x, y and
    camera z of `pcd_3d_to_pcd_2d`, what the scene reader's near/far planes
    take; "rgb": the colours of a [N, 6] cloud splatted into an [H, W, 3]
    image; "bw": ones where a point falls; any other: its camera z
    splatted ([H, W, 1])."""
    if render_type == "rgb":
        if point_cloud.shape[1] != 6:
            raise ValueError(f"an rgb point cloud is [N, 6], not {point_cloud.shape}")
    else:
        point_cloud = point_cloud[:, :3]
    pcd_2d = pcd_3d_to_pcd_2d(point_cloud, capture.intrinsic_matrix, capture.extrinsic_matrix,
                              capture.size)
    if render_type == "pcd":
        return pcd_2d
    return pcd_2d_to_img(pcd_2d, capture.size, has_z=True,
                         keep_z=render_type not in ("bw", "rgb"))
