"""`collectives_per_step`: the counter `mesh.collectives` (the calls of
`DataMesh.all_reduce`, `broadcast` and `gather_rows`) a step
(benchmark/program_spans.py); a stage-1 step makes 4. None without a mesh
or the counter."""

from benchmark import program_spans


def read(ctx):
    return program_spans.counter(ctx, "step", "mesh.collectives")
