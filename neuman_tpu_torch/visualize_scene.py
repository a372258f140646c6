"""Draw a scene into a PNG: its coloured point cloud, the posed SMPL
vertices of every tenth frame in red and each camera's four centre-to-corner
edges in blue (the port's counterpart of visualize_scene.py, which draws
these with matplotlib where Open3D is missing).

    python -m neuman_tpu_torch.visualize_scene --scene_dir <dir>
        [--smpl_type romp|optimized] [--save_to scene_visualization.png]

The view is matplotlib's default 3-D one (elevation 30 degrees, azimuth
-60, z up, each axis scaled to its data's range in a 4:4:3 box), drawn
orthographically with z-buffered point splats and rasterised lines into a
1500x1500 image (the JAX script's 10 x 10 inch figure at 150 dpi), written
by utils/png.py. A debugging view: the scene is read on the host, the
cameras' corner rays come from ops/rays.pixels_to_rays on `device`.
"""

import argparse
import dataclasses

import numpy as np
import torch

from neuman_tpu_torch import train
from neuman_tpu_torch.data_io.neuman import NeuManReader
from neuman_tpu_torch.ops import rays as ray_ops
from neuman_tpu_torch.utils.png import write_png

VIEW_ELEV, VIEW_AZIM = 30.0, -60.0
BOX_ASPECT = (4.0, 4.0, 3.0)
IMAGE_HW = (1500, 1500)
# the drawing fills this share of the image's shorter side
FILL = 0.9
# a cloud or body point is a square of (2 * SPLAT_RADIUS + 1) pixels a side
SPLAT_RADIUS = 1
FRUSTUM_SIZE = 0.2
RED, BLUE, WHITE = (255, 0, 0), (0, 0, 255), (255, 255, 255)


def camera_poly(cap, size=1.0, device="cuda"):
    """(centre, then the points at `size` along the rays through the image's
    four corners (0, 0), (W, 0), (W, H), (0, H)): five [3] arrays."""
    h, w = cap.shape
    xy = torch.tensor([[0, 0], [w, 0], [w, h], [0, h]], dtype=torch.float32, device=device)
    as_f32 = lambda m: torch.as_tensor(np.asarray(m), dtype=torch.float32, device=device)
    origins, dirs = ray_ops.pixels_to_rays(xy, as_f32(cap.intrinsic_matrix),
                                           as_f32(cap.cam_pose.camera_to_world))
    orig = origins[0].cpu().numpy()
    return (orig, *(dirs.cpu().numpy() * size + orig))


@dataclasses.dataclass
class Geometry:
    """What the view draws: cloud [N, 3] with colours [N, 3] uint8, body
    points [M, 3], segments [K, 2, 3]."""

    cloud: np.ndarray
    colors: np.ndarray
    body: np.ndarray
    segments: np.ndarray

    def points(self):
        return np.concatenate([self.cloud, self.body, self.segments.reshape(-1, 3)])


def scene_geometry(scene, device="cuda"):
    """The point cloud, every max(1, n // 10)-th frame's vertices and each
    capture's frustum edges of `scene` (a NeuManReader scene)."""
    pc = np.asarray(scene.point_cloud)
    frames = scene.verts[::max(1, len(scene.verts) // 10)]
    segments = []
    for cap in scene.captures:
        pts = np.array(camera_poly(cap, size=FRUSTUM_SIZE, device=device))
        segments += [(pts[0], pts[j]) for j in range(1, 5)]
    return Geometry(pc[:, :3].astype(np.float64), pc[:, 3:6].astype(np.uint8),
                    np.concatenate([np.asarray(v, np.float64) for v in frames]),
                    np.asarray(segments, np.float64).reshape(-1, 2, 3))


class View:
    """matplotlib's default 3-D view of `points` [N, 3], orthographic,
    fitted to an image of `hw`: `project` gives each point's pixel (column,
    row) and its depth (larger is farther)."""

    def __init__(self, points, hw=IMAGE_HW):
        lo, hi = points.min(0), points.max(0)
        self.mid = (lo + hi) / 2
        self.scale = np.asarray(BOX_ASPECT) / max(BOX_ASPECT) / np.maximum(hi - lo, 1e-12)
        el, az = np.radians(VIEW_ELEV), np.radians(VIEW_AZIM)
        toward = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
        right = np.array([-np.sin(az), np.cos(az), 0.0])
        self.basis = np.stack([right, np.cross(toward, right), -toward])
        xy = self._screen(points)[:, :2]
        xy_lo, xy_hi = xy.min(0), xy.max(0)
        self.zoom = FILL * min(hw) / max((xy_hi - xy_lo).max(), 1e-12)
        self.center = (xy_lo + xy_hi) / 2
        self.hw = hw

    def _screen(self, points):
        return ((points - self.mid) * self.scale) @ self.basis.T

    def project(self, points):
        """(column [N] int, row [N] int, depth [N])."""
        s = self._screen(points)
        col = np.round(self.hw[1] / 2 + self.zoom * (s[:, 0] - self.center[0])).astype(np.int64)
        row = np.round(self.hw[0] / 2 - self.zoom * (s[:, 1] - self.center[1])).astype(np.int64)
        return col, row, s[:, 2]


def _splat(image, zbuf, col, row, depth, colors, radius):
    """Draw each point as a square of side 2 * radius + 1 where it is nearer
    than what the pixel holds; among points on one pixel the nearest wins."""
    h, w = zbuf.shape
    offsets = np.arange(-radius, radius + 1)
    dc, dr = (o.reshape(-1) for o in np.meshgrid(offsets, offsets))
    c = (col[:, None] + dc[None]).reshape(-1)
    r = (row[:, None] + dr[None]).reshape(-1)
    d = np.repeat(depth, len(dc))
    rgb = np.repeat(colors, len(dc), axis=0)
    inside = (c >= 0) & (c < w) & (r >= 0) & (r < h)
    flat, d, rgb = (r * w + c)[inside], d[inside], rgb[inside]
    order = np.lexsort((d, flat))  # by pixel, nearest first
    flat, d, rgb = flat[order], d[order], rgb[order]
    first = np.unique(flat, return_index=True)[1]
    flat, d, rgb = flat[first], d[first], rgb[first]
    nearer = d < zbuf.reshape(-1)[flat]
    zbuf.reshape(-1)[flat[nearer]] = d[nearer]
    image.reshape(-1, 3)[flat[nearer]] = rgb[nearer]


def _line_samples(view, segments):
    """(col, row, depth) of a sample every pixel or less along each segment."""
    ends = [view.project(segments[:, j]) for j in (0, 1)]
    (c0, r0, d0), (c1, r1, d1) = ends
    steps = np.maximum(np.abs(c1 - c0), np.abs(r1 - r0)) + 1
    seg = np.repeat(np.arange(len(segments)), steps)
    t = (np.arange(steps.sum()) - np.repeat(np.cumsum(steps) - steps, steps)) / np.maximum(
        np.repeat(steps - 1, steps), 1)
    lerp = lambda a, b: a[seg] + t * (b[seg] - a[seg])
    return (np.round(lerp(c0, c1)).astype(np.int64), np.round(lerp(r0, r1)).astype(np.int64),
            lerp(d0, d1))


def draw(geometry, hw=IMAGE_HW):
    """(image [H, W, 3] uint8 on white, its View)."""
    view = View(geometry.points(), hw)
    image = np.full((*hw, 3), WHITE, dtype=np.uint8)
    zbuf = np.full(hw, np.inf)
    col, row, depth = view.project(geometry.cloud)
    _splat(image, zbuf, col, row, depth, geometry.colors, SPLAT_RADIUS)
    col, row, depth = view.project(geometry.body)
    _splat(image, zbuf, col, row, depth, np.tile(RED, (len(depth), 1)), SPLAT_RADIUS)
    col, row, depth = _line_samples(view, geometry.segments)
    _splat(image, zbuf, col, row, depth, np.tile(BLUE, (len(depth), 1)), 0)
    return image, view


def main(argv=None, device="cuda"):
    """Read the scene as the JAX script does (normalized, background range
    x3, human range x1.5), draw it and write the PNG. Returns its path."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene_dir", type=str, required=True)
    parser.add_argument("--smpl_type", default="optimized", choices=["romp", "optimized"])
    parser.add_argument("--save_to", type=str, default="scene_visualization.png")
    opt = parser.parse_args(argv)
    train.require_device(device, "visualize_scene.main")
    scene = NeuManReader.read_scene(opt.scene_dir, normalize=True, bkg_range_scale=3,
                                    human_range_scale=1.5, smpl_type=opt.smpl_type)
    image, _ = draw(scene_geometry(scene, device))
    write_png(opt.save_to, image)
    print(f"saved the scene's view to {opt.save_to}")
    return opt.save_to


if __name__ == "__main__":
    main()
