"""`batch_draw_ms`: the mean device time of the harness's call into the
sampler's batch draw, by CUDA events around it in the untraced window."""

from benchmark import readers


def read(ctx):
    return readers.batch_draw_ms(ctx)
