"""`lpips_ms.train`: the device time of the human step's LPIPS forward (`human.lpips`), a
step (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "step", "human.lpips", "device_ms")
