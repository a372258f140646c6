"""`forward_ms.train`: the device time of the stage-1 step's forward
(`step.forward`: CUDA events around `bkg_loss_fn`, the coarse pass, the
importance samples, the fine pass and the losses), a step
(benchmark/program_spans.py). None where the program has no such span."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "step", "step.forward", "device_ms")
