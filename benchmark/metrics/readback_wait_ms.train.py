"""`readback_wait_ms.train`: the host's time blocked in the step's one read-back
(`step.readback`), a step (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "step", "step.readback", "host_ms")
