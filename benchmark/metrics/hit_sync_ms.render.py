"""`hit_sync_ms.render`: the host's time blocked on a frame's hit lists
(`render.hit_sync`), a frame (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "frame", "render.hit_sync", "host_ms")
