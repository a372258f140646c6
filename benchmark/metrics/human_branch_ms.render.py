"""`human_branch_ms.render`: the device time of a frame's human branches
(`render.human_branch`), a frame (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "frame", "render.human_branch", "device_ms")
