"""`allreduce_roofline.train`: the NCCL all-reduce kernels' share of their
roofline in a step. The least time is the step's all-reduce bus bytes
(2(n-1)/n x the bytes of its reductions, counted from the widths:
benchmark/collectives.py, the runner's `work()["allreduce"]`) at the
published NVLink bandwidth; the time is that of the trace's
`ncclDevKernel_AllReduce*` and `ncclKernel_AllReduce*` kernels, which spin
while a peer is late. None without such kernels or such work."""

from benchmark import collectives

KERNELS = ("ncclDevKernel_AllReduce", "ncclKernel_AllReduce")


def read(ctx):
    bus = ctx.traced_work.get("allreduce") if ctx.unit == "step" else None
    dev = sum(dur for base, _, _, dur in ctx.trace.kernels if base.startswith(KERNELS)) * 1e-6
    if not bus or dev <= 0.0:
        return None
    return 100.0 * collectives.least_s(bus) * ctx.trace.units / dev
