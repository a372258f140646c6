"""`idle_pct.train`: see benchmark/readers.py `idle_pct`, for a step."""

from benchmark import readers


def read(ctx):
    return readers.idle_pct(ctx, "step")
