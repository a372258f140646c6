"""What the per-layer metrics compute, shared by their readers in
benchmark/metrics/ (one file a metric, found by the metric's name). Each
returns None where the run has nothing to read: another kind of unit, no
device trace, no kernel of the kind."""

# the kernels that compute the NeRF MLP's work: the forward, the backward's
# chain pass and direction pass, and its dW pass and reduction; `dw_kernel`
# and `dw_reduce_kernel` are shared with the offset net's backward, so a dW
# launch belongs to the backward whose chain pass ran last before it
NERF_MLP = {"nerf_mlp_kernel", "bwd_chain_kernel", "bwd_ddir_kernel"}
NERF_CHAIN, OTHER_CHAINS = "bwd_chain_kernel", {"offset_chain_kernel"}
SHARED_DW = {"dw_kernel", "dw_reduce_kernel"}


def nerf_mlp_device_s(trace):
    """Device seconds of the NeRF MLP's kernels in the traced window."""
    total, owner = 0.0, None
    for base, _, _, dur in trace.kernels:
        if base == NERF_CHAIN:
            owner = "nerf"
        elif base in OTHER_CHAINS:
            owner = "other"
        if base in NERF_MLP or (base in SHARED_DW and owner == "nerf"):
            total += dur * 1e-6
    return total


def roofline(ctx, unit):
    """% of the NeRF MLP's kernels' device time that the least time of its
    work at the published peaks would take."""
    if ctx.unit != unit:
        return None
    dev = nerf_mlp_device_s(ctx.trace)
    if dev <= 0.0:
        return None
    f, b = ctx.traced_work["nerf_mlp"]
    least = ctx.roofline_s(f, b, ctx.traced_work["dtype"]) * ctx.trace.units
    return 100.0 * least / dev


def mfu(ctx, unit):
    """% of the peak for the compute dtype that a unit's model FLOPs over
    the untraced window's time a unit make."""
    if ctx.unit != unit or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * ctx.work["model_flops"] / ctx.unit_s / ctx.peak_flops[ctx.work["dtype"]]


def idle_pct(ctx, unit):
    if ctx.unit != unit or ctx.trace.window_s <= 0.0 or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def launches(ctx, unit):
    if ctx.unit != unit or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.units


def peak_gib(ctx, unit):
    if ctx.unit != unit or not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2**30


def batch_draw_ms(ctx):
    if ctx.unit != "step" or not ctx.draw_ms:
        return None
    return sum(ctx.draw_ms) / len(ctx.draw_ms)
