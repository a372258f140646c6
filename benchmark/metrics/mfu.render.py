"""`mfu.render`: see benchmark/readers.py `mfu`, for a frame."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "frame")
