"""`face_pileup.train`: the most samples of a human step that share one closest face
(`warp.face_pileup`), a step's mean (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.counter(ctx, "step", "warp.face_pileup")
