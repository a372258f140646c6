"""`idle_pct.render`: see benchmark/readers.py `idle_pct`, for a frame."""

from benchmark import readers


def read(ctx):
    return readers.idle_pct(ctx, "frame")
