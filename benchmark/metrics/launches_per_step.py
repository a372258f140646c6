"""`launches_per_step`: device kernels a step in the profiler's trace."""

from benchmark import readers


def read(ctx):
    return readers.launches(ctx, "step")
