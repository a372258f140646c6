"""COLMAP text reconstruction reader (the port's copy of
neuman_tpu/data_io/colmap.py).

Reads `cameras.txt` (SIMPLE_RADIAL, PINHOLE and OPENCV cameras as
pinholes; distortion dropped), `images.txt` (a quaternion and translation,
world to camera, per image) and `points3D.txt` (xyz and rgb).
`order="video"` sorts the captures by file name and gives each its
`frame_id` {frame_id, total_frames}.
"""

import os
import re
from collections import namedtuple

import numpy as np

from neuman_tpu_torch.cameras.capture import RGBPinholeCapture
from neuman_tpu_torch.cameras.pinhole import PinholeCamera
from neuman_tpu_torch.cameras.pose import CameraPose
from neuman_tpu_torch.geometry.rotation import Rotation, Translation
from neuman_tpu_torch.scenes.scene import ImageFileScene

ImageMeta = namedtuple("ImageMeta", ["image_id", "camera_pose", "camera_id", "image_path"])
_NUMBER = r"[-+]?\d*\.\d+|\d+"


def _expect(fid, line, path):
    got = fid.readline()
    if got != line:
        raise ValueError(f"{path}: expected {line!r}, read {got!r}")


def _count(fid, pattern, path):
    line = fid.readline()
    if not re.search(pattern, line):
        raise ValueError(f"{path}: expected a count line, read {line!r}")
    return int(re.findall(_NUMBER, line)[0])


class ColmapAsciiReader:
    @classmethod
    def read_scene(cls, scene_dir, images_dir, tgt_size=None, order="default"):
        captures = cls.read_captures(os.path.join(scene_dir, "images.txt"),
                                     os.path.join(scene_dir, "cameras.txt"), images_dir,
                                     tgt_size, order)
        point_cloud = cls.read_point_cloud(os.path.join(scene_dir, "points3D.txt"))
        return ImageFileScene(captures, point_cloud)

    @staticmethod
    def read_point_cloud(points_txt_path):
        """[N, 6] float32: xyz, rgb."""
        with open(points_txt_path, "r") as fid:
            _expect(fid, "# 3D point list with one line of data per point:\n", points_txt_path)
            _expect(fid, "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                    "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n", points_txt_path)
            num_points = _count(
                fid, r"^# Number of points: \d+, mean track length: [-+]?\d*\.\d+|\d+\n$",
                points_txt_path)
            xyz = np.zeros((num_points, 3), dtype=np.float32)
            rgb = np.zeros((num_points, 3), dtype=np.float32)
            for i in range(num_points):
                elems = fid.readline().split()
                xyz[i] = list(map(float, elems[1:4]))
                rgb[i] = list(map(float, elems[4:7]))
        return np.concatenate([xyz, rgb], axis=1)

    @classmethod
    def read_captures(cls, images_txt_path, cameras_txt_path, images_dir, tgt_size,
                      order="default"):
        cameras = cls.read_cameras(cameras_txt_path)
        images_meta = cls.read_images_meta(images_txt_path, images_dir)
        keys = list(images_meta.keys())
        if order == "video":
            frames = [os.path.basename(images_meta[k].image_path) for k in keys]
            keys = [x for _, x in sorted(zip(frames, keys))]
        elif order != "default":
            raise ValueError(f"unknown order: {order}")
        captures = []
        for i, key in enumerate(keys):
            meta = images_meta[key]
            cap = RGBPinholeCapture(meta.image_path, cameras[meta.camera_id], meta.camera_pose,
                                    tgt_size=tgt_size)
            if order == "video":
                cap.frame_id = {"frame_id": i, "total_frames": len(images_meta)}
            captures.append(cap)
        return captures

    @classmethod
    def read_cameras(cls, cameras_txt_path):
        cameras = {}
        with open(cameras_txt_path, "r") as fid:
            _expect(fid, "# Camera list with one line of data per camera:\n", cameras_txt_path)
            _expect(fid, "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n", cameras_txt_path)
            num_cams = _count(fid, r"^# Number of cameras: \d+\n$", cameras_txt_path)
            for _ in range(num_cams):
                elems = fid.readline().split()
                camera_id, model = int(elems[0]), elems[1]
                if model == "SIMPLE_RADIAL":
                    width, height, f, cx, cy, _ = list(map(float, elems[2:]))
                    cam = PinholeCamera(width, height, f, f, cx, cy)
                elif model in ("PINHOLE", "OPENCV"):
                    width, height, fx, fy, cx, cy = list(map(float, elems[2:8]))
                    cam = PinholeCamera(width, height, fx, fy, cx, cy)
                else:
                    raise ValueError(f"unsupported camera: {model}")
                if camera_id in cameras:
                    raise ValueError(f"{cameras_txt_path}: camera {camera_id} appears twice")
                cameras[camera_id] = cam
        return cameras

    @classmethod
    def read_images_meta(cls, images_txt_path, images_dir):
        images_meta = {}
        with open(images_txt_path, "r") as fid:
            _expect(fid, "# Image list with two lines of data per image:\n", images_txt_path)
            _expect(fid, "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n",
                    images_txt_path)
            _expect(fid, "#   POINTS2D[] as (X, Y, POINT3D_ID)\n", images_txt_path)
            num_images = _count(
                fid, r"^# Number of images: \d+, mean observations per image: "
                r"[-+]?\d*\.\d+|\d+\n$", images_txt_path)
            for _ in range(num_images):
                elems = fid.readline().split()
                if len(elems) != 10:
                    raise ValueError(f"{images_txt_path}: an image line has 10 fields, not "
                                     f"{len(elems)}")
                fid.readline()  # the POINTS2D line, unused
                image_path = os.path.join(images_dir, elems[9])
                if not os.path.isfile(image_path):
                    raise FileNotFoundError(f"missing file: {image_path}")
                image_id = int(elems[0])
                qw, qx, qy, qz, tx, ty, tz = list(map(float, elems[1:8]))
                pose = CameraPose(Translation(np.array([tx, ty, tz], dtype=np.float32)),
                                  Rotation(np.array([qw, qx, qy, qz], dtype=np.float32)))
                if image_id in images_meta:
                    raise ValueError(f"duplicated image id: {image_id}")
                images_meta[image_id] = ImageMeta(image_id, pose, int(elems[8]), image_path)
        return images_meta
