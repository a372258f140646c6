"""`hit_rays.render`: the rays of a frame that run the human branch (`render.hit_rays`),
a frame's mean (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.counter(ctx, "frame", "render.hit_rays")
