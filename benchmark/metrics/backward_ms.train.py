"""`backward_ms.train`: the device time of the step's backward (`step.backward`: CUDA
events around `torch.autograd.grad`), a step (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "step", "step.backward", "device_ms")
