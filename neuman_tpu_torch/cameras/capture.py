"""Captures: a pinhole camera, its pose and what was captured (the port's
copy of neuman_tpu/cameras/capture.py).

`ResizedPinholeCapture` is a camera alone at a target size (the render
command lines' synthetic views). `Capture` is one NeuMan frame: RGB image, MVS depth, human mask, and
optionally mono depth, keypoints and DensePose, each read when first asked
for; its rig ids, per-source near/far planes and frame id. `tgt_size`
(H, W) resizes the camera and every image and depth map.
"""

import numpy as np

from neuman_tpu_torch.cameras import contents
from neuman_tpu_torch.cameras.pinhole import resize_pinhole_camera
from neuman_tpu_torch.geometry import pcd
from neuman_tpu_torch.utils.misc import fused_depth


class BasePinholeCapture:
    def __init__(self, pinhole_cam, cam_pose):
        self.cam_pose = cam_pose
        self.pinhole_cam = pinhole_cam

    def __str__(self):
        return f"pinhole camera: {self.pinhole_cam}\ncamera pose: {self.cam_pose}"

    @property
    def mvp_mat(self):
        """The 3x4 projection: intrinsic @ world-to-camera."""
        return np.matmul(self.pinhole_cam.intrinsic_matrix, self.cam_pose.extrinsic_matrix)

    @property
    def intrinsic_matrix(self):
        return self.pinhole_cam.intrinsic_matrix

    @property
    def extrinsic_matrix(self):
        return self.cam_pose.extrinsic_matrix

    @property
    def shape(self):
        return self.pinhole_cam.shape

    @property
    def size(self):
        return self.shape


class ResizedPinholeCapture(BasePinholeCapture):
    """A camera-only capture at a target size (H, W)."""

    def __init__(self, pinhole_cam, cam_pose, tgt_size):
        super().__init__(resize_pinhole_camera(pinhole_cam, tgt_size), cam_pose)


class RGBPinholeCapture(BasePinholeCapture):
    """A capture with an image (what the COLMAP reader gives)."""

    def __init__(self, image_path, pinhole_cam, cam_pose, tgt_size=None):
        if tgt_size is not None:
            pinhole_cam = resize_pinhole_camera(pinhole_cam, tgt_size)
        super().__init__(pinhole_cam, cam_pose)
        self.captured_image = contents.CapturedImage(image_path, tgt_size=tgt_size)

    def read_image_to_ram(self):
        return self.captured_image.read_image_to_ram()

    @property
    def image_path(self):
        return self.captured_image.image_path

    @property
    def image(self):
        img = self.captured_image.image
        if img.shape[0:2] != self.pinhole_cam.shape:
            raise ValueError(f"image {img.shape} does not match the camera: {self.pinhole_cam}")
        return img


class Capture(RGBPinholeCapture):
    """One NeuMan frame: RGB, MVS depth and mask (and mono depth, keypoints,
    DensePose), with rig ids and per-source ("bkg", "human") near/far."""

    def __init__(self, image_path, depth_path, mask_path, pinhole_cam, cam_pose, view_id=0,
                 cam_id=0, tgt_size=None, mono_depth_path=None, keypoints_path=None,
                 densepose_path=None):
        super().__init__(image_path, pinhole_cam, cam_pose, tgt_size=tgt_size)
        self.view_id = view_id
        self.cam_id = cam_id
        self.captured_depth = contents.CapturedDepth(depth_path, tgt_size=tgt_size)
        self.captured_mask = contents.CapturedImage(mask_path, tgt_size=tgt_size,
                                                    sampling="nearest")
        self.captured_mono_depth = None
        if mono_depth_path is not None:
            self.captured_mono_depth = contents.CapturedDepth(mono_depth_path, tgt_size=tgt_size,
                                                              dataset="mono")
        # keypoints and DensePose are in pixels of the native size: read
        # only there, as the JAX package and the reference do
        self.keypoints = None
        if keypoints_path is not None and tgt_size is None:
            self.keypoints = np.load(keypoints_path)
        self.densepose = None
        if densepose_path is not None and tgt_size is None:
            self.densepose = np.load(densepose_path)
        self._fused_depth_map = None
        self.near = {}
        self.far = {}
        self.frame_id = None

    def read_image_to_ram(self):
        n = self.captured_image.read_image_to_ram()
        n += self.captured_mask.read_image_to_ram()
        if self.captured_mono_depth is not None:
            n += self.captured_mono_depth.read_depth_to_ram()
        return n

    def read_depth_to_ram(self):
        return self.captured_depth.read_depth_to_ram()

    @property
    def depth_path(self):
        return self.captured_depth.depth_path

    @property
    def depth_map(self):
        depth = self.captured_depth.depth_map
        if not (depth >= 0).all():
            raise ValueError(f"negative depth in {self.depth_path}")
        return depth

    @property
    def mask(self):
        """Human mask: 1 on the human, 0 on the background (a Detectron2
        mask holds 255 on the background and is inverted)."""
        m = self.captured_mask.image.copy()
        if m.max() != 255:
            raise ValueError("expected a 255-valued Detectron2 mask")
        m[m == 255] = 1
        m = 1 - m
        if m.sum() <= 0:
            raise ValueError(f"{self.captured_mask.image_path}: the mask holds no human")
        if m.shape[0:2] != self.pinhole_cam.shape:
            raise ValueError(f"mask {m.shape} does not match the camera: {self.pinhole_cam}")
        return m

    @property
    def binary_mask(self):
        m = self.mask.copy()
        m[m > 0] = 1
        return m

    @property
    def mono_depth_map(self):
        return self.captured_mono_depth.depth_map

    @property
    def fused_depth_map(self):
        """MVS depth with its holes filled by the mono depth, calibrated by
        a line fitted on the valid background pixels."""
        if self._fused_depth_map is None:
            self._fused_depth_map = fused_depth(self.depth_map.astype(np.float32),
                                                self.mono_depth_map.astype(np.float32),
                                                self.binary_mask.astype(np.uint8))
        return self._fused_depth_map

    def point_cloud_world(self):
        """[M, 3] float32 world points of the depth map's pixels with depth
        > 0."""
        return pcd.img_to_pcd_3d(self.depth_map, self.pinhole_cam.intrinsic_matrix,
                                 cam2world=self.cam_pose.camera_to_world).astype(np.float32)
