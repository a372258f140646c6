"""Step-by-step times of the bench's human train step, on the GPU: what
moves `human_train_step_ms` with the length of its window.

    python -m neuman_tpu_torch.tools.bench_step_windows

On the bench's human section (`bench.human_setup` at its defaults), after
the bench's one warm-up step, STEPS (40) steps back to back with a CUDA event
recorded after each: a step's ms is the stream time from the event before
it to its own, the time the bench's window divides. Meanwhile Python's
garbage collections are timed (gc.callbacks) and nvidia-smi samples the SM
clock, power draw and temperature every 100 ms. Prints one line a step (ms,
gc ms, restarts of a dead canonical net, the median of the samples read
while it ran) and the mean ms of each window.

Then, on a fresh setup, each window (a, b) of WINDOWS (steps a to b - 1
after the warm-up: 0:3, the steps `chip_smoke.py` times, and 10:30) is
traced by torch.profiler: its wall ms a step, device ms a step and idle
share, and the device ms a step of the TOP (12) kernels that take the most
in the last window, window beside window.
"""

import gc
import statistics
import subprocess
import sys
import threading
import time

import torch

from neuman_tpu_torch import bench

SMI_FIELDS = ("clocks.sm", "power.draw", "temperature.gpu")
STEPS = 40
WINDOWS = ((0, 3), (10, 30))
TOP = 12


class SmiSampler:
    """nvidia-smi's SMI_FIELDS every 100 ms, each sample stamped with the
    host clock (time.perf_counter) when it was read."""

    def __init__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=" + ",".join(SMI_FIELDS), "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                values = [float(v) for v in line.split(",")]
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), values))

    def between(self, t0, t1):
        """Median of each field over the samples read in [t0, t1), or None."""
        got = [v for t, v in self.samples if t0 <= t < t1]
        return [statistics.median(col) for col in zip(*got)] if got else None

    def stop(self):
        self.proc.terminate()
        self.proc.wait(timeout=10)
        self.thread.join(timeout=10)


class GcTimer:
    """Host ms spent in Python's garbage collections, a running total."""

    def __init__(self):
        self.ms, self._t0 = 0.0, None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3

    def stop(self):
        gc.callbacks.remove(self._callback)


def per_step(device, steps):
    """[(ms, gc ms, restart, host start, host end)] of `steps` steps after
    one warm-up step, a CUDA event after each."""
    restarts = []
    step = bench.human_step_fn(bench.human_setup(device), restarts)
    step()
    bench._sync(device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    timer, host, gc_ms = GcTimer(), [time.perf_counter()], []
    events[0].record()
    try:
        for i in range(steps):
            step()
            events[i + 1].record()
            host.append(time.perf_counter())
            gc_ms.append(timer.ms)
    finally:
        timer.stop()
    bench._sync(device)
    gc_ms = [b - a for a, b in zip([0.0] + gc_ms, gc_ms)]
    return [(events[i].elapsed_time(events[i + 1]), gc_ms[i], restarts[i + 1], host[i],
             host[i + 1]) for i in range(steps)]


def traced_windows(device, windows):
    """[(wall ms a step, {kernel: device ms a step})] of each window a:b, on
    a fresh setup, the steps between the windows run untraced."""
    step = bench.human_step_fn(bench.human_setup(device), [])
    step()
    done, out = 0, []
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for a, b in windows:
        for _ in range(done, a):
            step()
        bench._sync(device)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(a, b):
                step()
            bench._sync(device)
            wall = (time.perf_counter() - t0) * 1e3 / (b - a)
        done = b
        kernels = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
                kernels[e.key] = kernels.get(e.key, 0.0) + e.device_time_total / 1e3 / (b - a)
        if not kernels:
            raise RuntimeError("bench_step_windows: the trace holds no device time")
        out.append((wall, kernels))
    return out


def main():
    if not torch.cuda.is_available():
        print("bench_step_windows: no CUDA device; this tool times CUDA streams only",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(bench.card_line(device), flush=True)

    smi = SmiSampler()
    try:
        rows = per_step(device, STEPS)
    finally:
        smi.stop()
    print("step ms gc_ms restart " + " ".join(SMI_FIELDS))
    for i, (ms, gcm, restart, t0, t1) in enumerate(rows):
        sampled = smi.between(t0, t1)
        print(f"{i} {ms:.3f} {gcm:.3f} {restart:g} "
              + (" ".join(f"{v:g}" for v in sampled) if sampled else "-"), flush=True)
    for a, b in WINDOWS:
        got = [r[0] for r in rows[a:b]]
        print(f"window {a}:{b} mean ms {sum(got) / len(got):.3f} over {len(got)} steps")

    traced = traced_windows(device, WINDOWS)
    names = sorted(traced[-1][1], key=traced[-1][1].get, reverse=True)[:TOP]
    print("traced " + " | ".join(f"{a}:{b}" for a, b in WINDOWS))
    print("wall_ms " + " | ".join(f"{wall:.3f}" for wall, _ in traced))
    device_ms = [sum(k.values()) for _, k in traced]
    print("device_ms " + " | ".join(f"{ms:.3f}" for ms in device_ms))
    print("idle_share " + " | ".join(f"{1 - ms / wall:.4f}"
                                     for ms, (wall, _) in zip(device_ms, traced)))
    for name in names:
        print(" | ".join(f"{k.get(name, 0.0):9.3f}" for _, k in traced) + f"  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
