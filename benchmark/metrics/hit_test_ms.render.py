"""`hit_test_ms.render`: the device time of a frame's hit tests (`render.hit_test`), a
frame (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "frame", "render.hit_test", "device_ms")
