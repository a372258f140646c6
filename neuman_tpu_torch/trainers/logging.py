"""Training metrics (counterpart of neuman_tpu/trainers/logging.py).

`MetricsPusher` appends one JSON object per push to `metrics.jsonl` in the
run's output directory (the JAX package's jsonl sink; its tensorboardX
writer is not ported) and writes validation images beside it as PNG files
(utils/png.py: the port depends on no image library, and a failure to
write raises); `ThroughputMeter` gives steps/s and ray-samples/s.
"""

import json
import os
import time

import numpy as np

from neuman_tpu_torch.utils.png import decode_png, encode_png  # noqa: F401

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
