"""`peak_gib.train`: see benchmark/readers.py `peak_gib`, for a step."""

from benchmark import readers


def read(ctx):
    return readers.peak_gib(ctx, "step")
