"""Image and depth contents of a capture, read when first asked for and
optionally kept in memory (the port's copy of
neuman_tpu/cameras/contents.py, on utils/png.py and utils/resize.py in
place of imageio and PIL):
- images are read from PNG, resized BILINEAR to `tgt_size`; masks NEAREST;
- a COLMAP dense `.bin` depth map is clipped to the 95th percentile of its
  positive depths; a mono depth PNG is scaled by 1/10000;
- a depth path that ends in `dummy` gives zeros at the image's size.
"""

import os

import numpy as np

from neuman_tpu_torch.utils import png
from neuman_tpu_torch.utils.resize import resize


def read_colmap_depth_bin(path):
    """A COLMAP dense array ("width&height&channels&" then column-major
    float32) as [H, W] (or [H, W, C])."""
    with open(path, "rb") as fid:
        header = b""
        while header.count(b"&") < 3:
            byte = fid.read(1)
            if not byte:
                raise ValueError(f"{path}: no COLMAP array header")
            header += byte
        width, height, channels = (int(v) for v in header.split(b"&")[:3])
        array = np.fromfile(fid, np.float32)
    array = array.reshape((width, height, channels), order="F")
    return np.transpose(array, (1, 0, 2)).squeeze()


def write_colmap_depth_bin(path, depth):
    """Inverse of `read_colmap_depth_bin` for an [H, W] map."""
    h, w = depth.shape
    with open(path, "wb") as fid:
        fid.write(f"{w}&{h}&1&".encode())
        arr = np.transpose(depth[..., None], (1, 0, 2)).astype(np.float32)
        arr.flatten(order="F").tofile(fid)


class CapturedImage:
    def __init__(self, image_path, tgt_size=None, sampling="bilinear"):
        if not os.path.isfile(image_path):
            raise FileNotFoundError(f"file does not exist: {image_path}")
        self._image = None
        self.image_path = image_path
        self.tgt_size = tgt_size
        self.sampling = sampling

    def read_image(self):
        if self.image_path.endswith(".npy"):
            img = np.load(self.image_path)
        else:
            img = png.read_png(self.image_path)
        if self.tgt_size is not None:
            img = resize(img, self.tgt_size, self.sampling)
        return img

    def read_image_to_ram(self):
        if self._image is not None:
            raise RuntimeError(f"{self.image_path} is already in memory")
        self._image = self.read_image()
        return self._image.nbytes

    @property
    def image(self):
        if self._image is not None:
            return self._image
        return self.read_image()


class CapturedDepth:
    def __init__(self, depth_path, scale=1, tgt_size=None, dataset="mvs"):
        if not depth_path.endswith("dummy") and not os.path.isfile(depth_path):
            raise FileNotFoundError(f"file does not exist: {depth_path}")
        self._depth = None
        self.depth_path = depth_path
        self.scale = scale
        self.tgt_size = tgt_size
        self.dataset = dataset

    def read_depth(self):
        if self.depth_path.endswith("dummy"):
            w, h = png.png_size(self.depth_path[: -len("dummy")])
            depth = np.zeros([h, w], dtype=np.float32)
        elif self.depth_path.endswith(".png"):
            if self.dataset != "mono":
                raise ValueError(f"a PNG depth map is mono depth: {self.depth_path}")
            depth = png.read_png(self.depth_path) / 10000.0
        elif self.depth_path.endswith(".bin"):
            depth = read_colmap_depth_bin(self.depth_path)
            depth[depth < 0] = 0
            positive = depth[depth > 0]
            max_depth = np.percentile(positive, 95) if positive.size else 0
            depth[depth > max_depth] = 0
        else:
            raise ValueError(f"unsupported depth file: {self.depth_path}")
        if self.tgt_size is not None:
            # PIL holds a depth map as a float32 image
            depth = resize(depth.astype(np.float32), self.tgt_size, "nearest")
        return depth * self.scale

    def read_depth_to_ram(self):
        if self._depth is not None:
            raise RuntimeError(f"{self.depth_path} is already in memory")
        self._depth = self.depth_map
        return self._depth.nbytes

    @property
    def depth_map(self):
        if self._depth is not None:
            return self._depth
        return self.read_depth()
