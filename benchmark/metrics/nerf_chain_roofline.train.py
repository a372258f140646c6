"""`nerf_chain_roofline.train`: the NeRF backward's chain pass's share of
its roofline in a step. Work: the model's dX products, a third of the
trained NeRF MLP FLOPs of `traced_work["nerf_mlp"]` (benchmark/flops.py
counts the forward once and the backward twice, dX and dW), at the peak of
the configuration's compute dtype. Time: the device time of the chain
pass's kernels, `bwd_chain_kernel` and `bwd_ddir_kernel`, in the traced
window (what the pass recomputes of the forward is paid for in its time)."""

from benchmark import readers

CHAIN = {readers.NERF_CHAIN, "bwd_ddir_kernel"}


def read(ctx):
    if ctx.unit != "step":
        return None
    dev = sum(dur for base, _, _, dur in ctx.trace.kernels if base in CHAIN) * 1e-6
    if dev <= 0.0:
        return None
    f, _ = ctx.traced_work["nerf_mlp"]
    least = ctx.roofline_s(f / 3.0, 0, ctx.traced_work["dtype"]) * ctx.trace.units
    return 100.0 * least / dev
