"""Training metrics (counterpart of neuman_tpu/trainers/logging.py).

`MetricsPusher` appends one JSON object per push to `metrics.jsonl` in the
run's output directory (the JAX package's jsonl sink; its tensorboardX
writer is not ported) and writes validation images beside it as PNG files;
`ThroughputMeter` gives steps/s and ray-samples/s. The PNGs are written
here (zlib + struct, 8-bit RGB, no filtering): the port depends on no image
library, and a failure to write raises.
"""

import json
import os
import struct
import time
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def encode_png(img):
    """PNG bytes of an [H, W, 3] uint8 image: 8-bit RGB, filter 0 on every
    row, one IDAT chunk."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, not {img.dtype} {img.shape}")
    h, w, _ = img.shape

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (_PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def decode_png(data):
    """[H, W, 3] uint8 of a PNG that `encode_png` wrote (8-bit RGB, filter
    0, not interlaced); every chunk's CRC is checked."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    at, idat, header = 8, b"", None
    while at < len(data):
        (n,), tag = struct.unpack(">I", data[at:at + 4]), data[at + 4:at + 8]
        body = data[at + 8:at + 8 + n]
        if struct.unpack(">I", data[at + 8 + n:at + 12 + n])[0] != zlib.crc32(tag + body):
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        at += 12 + n
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError("decode_png reads 8-bit RGB, not interlaced, only")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError("decode_png reads filter type 0 only")
    return rows[:, 1:].reshape(h, w, 3).copy()


class MetricsPusher:
    """jsonl metrics sink in the run's output directory `opt.out`."""

    def __init__(self, opt):
        os.makedirs(opt.out, exist_ok=True)
        self.jsonl_path = os.path.join(opt.out, "metrics.jsonl")

    def push_scalars(self, iteration, scalars, training=True):
        record = {"iteration": iteration, "training": training}
        record.update({k: float(v) for k, v in scalars.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def push_images(self, iteration, images):
        """Write validation images as `<name>_<iteration:08d>.png` beside
        metrics.jsonl. images: {name: [H, W, 3] floats in [0, 1], or an
        [H, W] map, which is normalised to its own range for display}.
        Returns the paths written."""
        out_dir = os.path.dirname(self.jsonl_path)
        paths = []
        for name, img in images.items():
            img = np.asarray(img, dtype=np.float32)
            if img.ndim == 2:  # depth and acc maps
                lo, hi = float(img.min()), float(img.max())
                img = np.repeat(((img - lo) / max(hi - lo, 1e-9))[..., None], 3, axis=-1)
            img = np.clip(img, 0.0, 1.0)
            paths.append(os.path.join(out_dir, f"{name}_{iteration:08d}.png"))
            with open(paths[-1], "wb") as f:
                f.write(encode_png((img * 255).astype(np.uint8)))
        return paths


class ThroughputMeter:
    """steps/s and ray-samples/s since the last reset."""

    def __init__(self, samples_per_step):
        self.samples_per_step = samples_per_step
        self.reset()

    def reset(self):
        self.t0 = time.time()
        self.steps = 0

    def tick(self, n=1):
        self.steps += n

    def rates(self):
        dt = max(time.time() - self.t0, 1e-9)
        sps = self.steps / dt
        return {"steps_per_sec": sps, "ray_samples_per_sec": sps * self.samples_per_step}
