"""`warp_ms.train`: the device time of the human step's `vertex_forward` and warp
(`human.warp`), a step (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "step", "human.warp", "device_ms")
