"""`mfu.train`: see benchmark/readers.py `mfu`, for a step."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "step")
