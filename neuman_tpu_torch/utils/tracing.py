"""The program's spans and counters, on the profiler's clock.

`span(name)` marks a piece of work; `count(name, n)` adds to a counter.
Both are off unless a torch profiler is recording (the benchmark's traced
window, the trainers' `--profile_dir`, `tools/profile_*`): then a span is
a `torch.profiler.record_function` in the profiler's trace, on the clock of
the device's kernels, and the recorder here keeps its name, its parent
span, its host start and end (`time.perf_counter_ns`) and, once CUDA is in
use, a pair of CUDA events recorded on the current stream at its start and
end. Off, a span costs one flag check and a shared no-op context, and no
span or counter ever syncs the host.

`count(name, n)` with a Python int adds to a host total always (the kernel
wrappers' `launches.<kernel>` counters, read by `total`); while a profiler
records it also goes to the recorder. A device tensor `n` is taken only
while a profiler records, kept as it is and summed once, by `snapshot()`.

`snapshot()` gives what the recorder holds: for each span name its calls,
host ms, self host ms (host ms less its child spans') and device ms (start
event to end event: how long the span held the stream, idle time inside it
included; None without CUDA), and each counter's sum. The recorder keeps
what was recorded while a profiler was on, until `reset()`.

Span names are dotted (`step.backward`, `render.hit_test`): the benchmark's
harness names its own spans `step`, `frame`, `batch_draw` and `train_step`.
"""

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_totals = {}


class _Recorder:
    def __init__(self):
        self.spans = []  # [name, parent, t0 ns, t1 ns, start event, end event]
        self.stack = []
        self.counts = {}
        self.tensors = {}


_rec = _Recorder()


def enabled():
    """Whether a torch profiler is recording: spans and counters record."""
    return _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def _span(name):
    r = _rec
    events = None
    if torch.cuda.is_initialized():
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    rec = [name, r.stack[-1][0] if r.stack else None, 0, 0, *(events or (None, None))]
    with torch.profiler.record_function(name):
        r.stack.append(rec)
        if events:
            events[0].record()
        rec[2] = time.perf_counter_ns()
        try:
            yield
        finally:
            rec[3] = time.perf_counter_ns()
            if events:
                events[1].record()
            r.stack.pop()
            r.spans.append(rec)


def span(name):
    """A context manager over a piece of work named `name` (dotted)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _span(name)


def count(name, n=1):
    """Add `n` to counter `name`: a Python int always (to the host total,
    and to the recorder while a profiler records), a device tensor only
    while a profiler records (summed at `snapshot()`)."""
    on = _autograd_profiler._is_profiler_enabled
    if isinstance(n, torch.Tensor):
        if on:
            _rec.tensors.setdefault(name, []).append(n.detach())
        return
    _totals[name] = _totals.get(name, 0) + n
    if on:
        _rec.counts[name] = _rec.counts.get(name, 0) + n


def total(name):
    """Host total of int counter `name` over the process's life."""
    return _totals.get(name, 0)


def snapshot():
    """{"spans": {name: {"calls", "host_ms", "self_host_ms", "device_ms"}},
    "counters": {name: sum}} of what the recorder holds."""
    if any(s[4] is not None for s in _rec.spans):
        torch.cuda.synchronize()
    spans = {}
    for name, _, t0, t1, *_ in _rec.spans:
        s = spans.setdefault(name, {"calls": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                    "device_ms": None})
        s["calls"] += 1
        s["host_ms"] += (t1 - t0) * 1e-6
        s["self_host_ms"] += (t1 - t0) * 1e-6
    for name, parent, t0, t1, start, end in _rec.spans:
        if parent in spans:  # a parent still open at the snapshot is not in it
            spans[parent]["self_host_ms"] -= (t1 - t0) * 1e-6
        if start is not None:
            spans[name]["device_ms"] = (spans[name]["device_ms"] or 0.0) + start.elapsed_time(end)
    counters = dict(_rec.counts)
    for name, ts in _rec.tensors.items():
        counters[name] = counters.get(name, 0) + torch.stack(
            [t.reshape(()).to(torch.float64) for t in ts]).sum().item()
    return {"spans": spans, "counters": counters}


def reset():
    """Drop what the recorder holds (the host totals stay)."""
    global _rec
    _rec = _Recorder()


class StepProfile:
    """torch.profiler over `steps` train steps from iteration 1 (the
    command line's `--profile_dir` / `--profile_steps`, as the JAX
    trainers'); `write` (the main rank) writes one chrome trace,
    `<out_dir>/<stage>_steps_<first>-<last>.json`, with the program's spans
    in it. A context manager over the train loop: call `before(iteration)`
    before each step and `after(iteration)` after it; leaving it stops a
    profiler still running and writes its trace."""

    def __init__(self, out_dir, steps, device, stage, write=True):
        self.out_dir, self.steps, self.stage = out_dir, steps, stage
        self.active = bool(out_dir) and write and steps > 0
        self.cuda = torch.device(device).type == "cuda"
        self.prof, self.first, self.last = None, None, None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._stop()

    def before(self, iteration):
        if self.active and self.prof is None and iteration == 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof, self.first = torch.profiler.profile(activities=acts), iteration
            self.prof.start()

    def after(self, iteration):
        self.last = iteration - 1
        if self.prof is not None and iteration >= self.first + self.steps:
            self._stop()

    def _stop(self):
        if self.prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        prof, self.prof, self.active = self.prof, None, False
        prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.out_dir, f"{self.stage}_steps_{self.first}-{self.last}.json"))
