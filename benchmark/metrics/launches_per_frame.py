"""`launches_per_frame`: device kernels a frame in the profiler's trace."""

from benchmark import readers


def read(ctx):
    return readers.launches(ctx, "frame")
