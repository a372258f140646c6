"""`merge_ms.render`: the device time of a frame's merges by z of the
background's and the actors' samples and their integration (`render.merge`,
the multi-person renderer), a frame (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "frame", "render.merge", "device_ms")
