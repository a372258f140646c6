"""`peak_gib.render`: see benchmark/readers.py `peak_gib`, for a frame."""

from benchmark import readers


def read(ctx):
    return readers.peak_gib(ctx, "frame")
