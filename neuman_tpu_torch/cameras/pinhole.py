"""Pinhole camera intrinsics (the port's copy of
neuman_tpu/cameras/pinhole.py; numpy)."""

import numpy as np


class PinholeCamera:
    def __init__(self, width, height, fx, fy, cx, cy):
        self.width = int(width)
        self.height = int(height)
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy

    def __str__(self):
        return (f"width: {self.width}, height: {self.height}, fx: {self.fx}, "
                f"fy: {self.fy}, cx: {self.cx}, cy: {self.cy}")

    @property
    def shape(self):
        return (self.height, self.width)

    @property
    def intrinsic_matrix(self):
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]])


def resize_pinhole_camera(pinhole_cam, tgt_size):
    """The intrinsics rescaled to a target (H, W)."""
    h, w = tgt_size
    scale_h = h / pinhole_cam.shape[0]
    scale_w = w / pinhole_cam.shape[1]
    return PinholeCamera(w, h, pinhole_cam.fx * scale_w, pinhole_cam.fy * scale_h,
                         pinhole_cam.cx * scale_w, pinhole_cam.cy * scale_h)
