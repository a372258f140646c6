"""The traced window of a --trace 1 run, and what the per-layer readers read.

`profile` runs `n` more units under torch.profiler (CPU and CUDA
activities), each inside a span of the harness's own ("step", "frame";
the train runners open "batch_draw" and "train_step" inside a step), and
reads the exported trace: the device's kernels, copies and sets, and the
harness's spans on the host. The device is busy where any of them runs
(the union of their intervals); an idle gap is named by the innermost
harness span open on the host when it began.
"""

import json
import os
import tempfile
import time
import types

import torch

from benchmark import flops

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("step", "frame", "batch_draw", "train_step")


def base_name(name):
    """A kernel's identifier: "void (anonymous namespace)::nerf_mlp_kernel<float,
    256>((anonymous namespace)::FwdArgs, int)" -> "nerf_mlp_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop)[0]
    return name.strip().split(" ")[-1].split("::")[-1]


class Trace:
    def __init__(self, events, units, unit_name):
        self.units, self.unit_name = units, unit_name
        dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                     key=lambda e: e["ts"])
        self.kernels = [(base_name(e["name"]), e["name"], float(e["ts"]), float(e["dur"]))
                        for e in dev if e["cat"] == "kernel"]
        self.device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
        self.spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                             and e.get("name") in SPANS), key=lambda s: s[1])
        units_spans = [s for s in self.spans if s[0] == unit_name]
        start = units_spans[0][1] if units_spans else (self.device[0][0] if self.device else 0.0)
        end = max([s[2] for s in units_spans] + [d[1] for d in self.device] + [start])
        self.start, self.end = start, end
        self.window_s = (end - start) * 1e-6
        self.busy = self._union()
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6

    def _union(self):
        out = []
        for a, b in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def gaps(self):
        """[(span name, seconds)] of the device's idle gaps in the window."""
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                out.append((self._span_at(a), (b - a) * 1e-6))
        return out

    def _span_at(self, t):
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "host"

    def breakdown(self):
        by_kernel = {}
        for _, full, _, dur in self.kernels:
            by_kernel[full[:120]] = by_kernel.get(full[:120], 0.0) + dur * 1e-6
        ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def profile(runner, n, device):
    """Trace `n` units of the runner."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            with torch.profiler.record_function(runner.unit_name):
                runner.unit()
        if cuda:
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, n, runner.unit_name)


def context(runner, tr, unit_s, draws, window_peak, hits=None):
    """What a metric reader reads: the traced window (`tr`), the untraced
    window's time per unit, the batch draws' CUDA-event times, the window's
    peak memory, and a unit's work (`work`: in the window on average,
    `traced_work`: the traced units' mean)."""
    draw_ms = None
    if draws:
        torch.cuda.synchronize()
        draw_ms = [a.elapsed_time(b) for a, b in draws]
    window_hits, traced_hits = (None, None) if hits is None else hits
    return types.SimpleNamespace(
        unit=runner.unit_name, trace=tr, unit_s=unit_s, draw_ms=draw_ms, peak_bytes=window_peak,
        work=runner.work(window_hits) if window_hits is not None else runner.work(),
        traced_work=runner.work(traced_hits) if traced_hits is not None else runner.work(),
        peak_flops=flops.PEAK_FLOPS, roofline_s=flops.roofline_s, base_name=base_name,
        now=time.perf_counter())
