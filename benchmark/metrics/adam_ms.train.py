"""`adam_ms.train`: the device time of the step's Adam update (`step.optimizer`), a step
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "step", "step.optimizer", "device_ms")
