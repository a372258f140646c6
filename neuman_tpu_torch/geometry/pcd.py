"""Projection of a world point cloud into a capture (the port's copy of
the part of neuman_tpu/geometry/pcd.py that the scene reader's near/far
planes use: `pcd_3d_to_pcd_2d` with keep_z, crop and filter_neg, pixel
coordinates; numpy float64 products as there, so the planes agree bit
for bit)."""

import numpy as np


def pcd_3d_to_pcd_2d(pcd, intrinsic, extrinsic, size):
    """[M, 3] pixel x, y and camera z of the points of `pcd` [N, 3] in front
    of the camera (`intrinsic` 3x3, `extrinsic` the 3x4 world-to-camera)
    whose projection falls inside an image of `size` (H, W), less its last
    row and column."""
    if pcd.ndim != 2 or pcd.shape[1] != 3:
        raise ValueError(f"a point cloud is [N, 3], not {pcd.shape}")
    xyzw = np.concatenate([pcd, np.ones_like(pcd[:, :1])], axis=1)
    cam_pts = ((intrinsic @ extrinsic) @ xyzw.T).T
    cam_pts = cam_pts[cam_pts[:, 2] > 0.0]
    img_pts = (cam_pts / cam_pts[:, 2:3])[:, :2]
    inside = ((img_pts[:, 0] >= 0) & (img_pts[:, 0] < size[1] - 1)
              & (img_pts[:, 1] >= 0) & (img_pts[:, 1] < size[0] - 1))
    return np.concatenate([img_pts[inside], cam_pts[inside][:, 2:3]], axis=1)


def project_point_cloud_at_capture(point_cloud, capture):
    """pcd_3d_to_pcd_2d of the xyz of `point_cloud` [N, 3+] at `capture`
    (duck-typed: .intrinsic_matrix, .extrinsic_matrix, .size): the JAX
    function's `render_type="pcd"`, the only one the scene reader uses."""
    return pcd_3d_to_pcd_2d(point_cloud[:, :3], capture.intrinsic_matrix,
                            capture.extrinsic_matrix, capture.size)
