"""What the program's own spans and counters read in the traced window
(neuman_tpu_torch/utils/tracing.py), a unit's mean: the recorder holds
what ran while the profiler recorded, which in a run is the traced units.
Each returns None where the run has nothing to read: another kind of unit,
a program without the tracing module or without the span or counter, or
no device time (the CPU)."""


def snapshot():
    try:
        from neuman_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def span_ms(ctx, unit, name, clock):
    """The span `name`'s `clock` ("host_ms" or "device_ms") a unit."""
    snap = snapshot() if ctx.unit == unit else None
    value = (snap or {}).get("spans", {}).get(name, {}).get(clock)
    return None if value is None else value / ctx.trace.units


def counter(ctx, unit, name):
    """The counter `name`'s sum a unit."""
    snap = snapshot() if ctx.unit == unit else None
    value = (snap or {}).get("counters", {}).get(name)
    return None if value is None else value / ctx.trace.units
