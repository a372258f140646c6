"""Training metrics (counterpart of neuman_tpu/trainers/logging.py).

`MetricsPusher` appends one JSON object per push to `metrics.jsonl` in the
run's output directory (the JAX package's jsonl sink; its tensorboardX
writer is not ported); `ThroughputMeter` gives steps/s and ray-samples/s.
"""

import json
import os
import time


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
