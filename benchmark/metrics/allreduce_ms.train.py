"""`allreduce_ms.train`: the device time of the span `mesh.all_reduce` (each
`DataMesh.all_reduce`, the wait for the slowest rank included), a step
(benchmark/program_spans.py). None without a mesh, CUDA or the span."""

from benchmark import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "step", "mesh.all_reduce", "device_ms")
